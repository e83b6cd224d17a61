from .convert import state_dict_from_jax
from .res3d import Res3D, init_res3d
from .resnet2d import ResNet50_2D, init_res2d
from .slowfast import SlowFast, init_my_slowfast, init_weights
from .sparse_fusion import SparseModel

__all__ = ["Res3D", "ResNet50_2D", "SlowFast", "SparseModel", "init_my_slowfast",
           "init_res2d", "init_res3d", "init_weights", "state_dict_from_jax"]
