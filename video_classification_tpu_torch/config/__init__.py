from . import crop_cfg
from .defaults import get_cfg, get_override_cfg, load_model_cfg
from .node import CfgNode, load_yaml

__all__ = ["CfgNode", "crop_cfg", "get_cfg", "get_override_cfg", "load_model_cfg",
           "load_yaml"]
