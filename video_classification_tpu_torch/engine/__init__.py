from .checkpoint import ckpt_dir, load_checkpoint, load_torch_warmstart, save_checkpoint
from .model_manager import ModelManager
from .predictor import EnsemblePredictor, Predictor
from .sparse import ResultSaver, SparseFusionDataset, SparseTrainer
from .trainer import Trainer, train_unimportant_parts

__all__ = ["EnsemblePredictor", "ModelManager", "Predictor", "ResultSaver",
           "SparseFusionDataset", "SparseTrainer", "Trainer", "ckpt_dir", "load_checkpoint",
           "load_torch_warmstart", "save_checkpoint", "train_unimportant_parts"]
