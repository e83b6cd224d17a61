from .convert import state_dict_from_jax
from .slowfast import SlowFast, init_my_slowfast, init_weights

__all__ = ["SlowFast", "init_my_slowfast", "init_weights", "state_dict_from_jax"]
