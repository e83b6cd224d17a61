from .dataset import (MISSING_FILL, NUM_MODALITY_CHANNELS, ChalearnVideoDataset,
                      eval_batches, train_batches)
from .pipeline import prefetch_to_device

__all__ = ["MISSING_FILL", "NUM_MODALITY_CHANNELS", "ChalearnVideoDataset",
           "eval_batches", "prefetch_to_device", "train_batches"]
