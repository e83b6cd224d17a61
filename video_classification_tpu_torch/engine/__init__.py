from .checkpoint import ckpt_dir, load_checkpoint, save_checkpoint
from .model_manager import ModelManager
from .predictor import Predictor

__all__ = ["ModelManager", "Predictor", "ckpt_dir", "load_checkpoint",
           "save_checkpoint"]
