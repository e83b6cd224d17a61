"""The v2 (video-native) pipeline: the port of the JAX package's ``v2/``."""

from . import part_compose
from .convert import (
    ConvertIuvPklToPartBox,
    ConvertIuvPklToUvVideo,
    ConvertVideoToFlow,
    ConvertVideoToIUVPkl,
)
from .dataset import V2_CHANNELS, ChalearnGestureDataset
from .part_compose import PartCompose
from .trainer import V2ModelManager, V2Trainer
from .video_io import VideoIO

__all__ = [
    "VideoIO",
    "part_compose",
    "PartCompose",
    "ConvertVideoToFlow",
    "ConvertVideoToIUVPkl",
    "ConvertIuvPklToUvVideo",
    "ConvertIuvPklToPartBox",
    "ChalearnGestureDataset",
    "V2_CHANNELS",
    "V2ModelManager",
    "V2Trainer",
]
