from .checkpoint import ckpt_dir, load_checkpoint, load_torch_warmstart, save_checkpoint
from .model_manager import ModelManager
from .parallel_streams import assign_device_groups, train_streams_parallel
from .predictor import EnsemblePredictor, Predictor
from .sparse import PART_YAMLS, ResultSaver, SparseFusionDataset, SparseTrainer
from .trainer import Trainer, train_unimportant_parts

__all__ = ["PART_YAMLS", "EnsemblePredictor", "ModelManager", "Predictor", "ResultSaver",
           "SparseFusionDataset", "SparseTrainer", "Trainer", "ckpt_dir", "load_checkpoint",
           "assign_device_groups", "load_torch_warmstart", "save_checkpoint",
           "train_streams_parallel", "train_unimportant_parts"]
