from .dataset import (MISSING_FILL, NUM_MODALITY_CHANNELS, ChalearnVideoDataset,
                      eval_batches, train_batches)
from .fixture import generate_fixture
from .pipeline import prefetch_to_device

__all__ = ["MISSING_FILL", "NUM_MODALITY_CHANNELS", "ChalearnVideoDataset",
           "eval_batches", "generate_fixture", "prefetch_to_device", "train_batches"]
