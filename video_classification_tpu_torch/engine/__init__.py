from .checkpoint import ckpt_dir, load_checkpoint, load_torch_warmstart, save_checkpoint
from .model_manager import ModelManager
from .predictor import Predictor
from .trainer import Trainer, train_unimportant_parts

__all__ = ["ModelManager", "Predictor", "Trainer", "ckpt_dir", "load_checkpoint",
           "load_torch_warmstart", "save_checkpoint", "train_unimportant_parts"]
