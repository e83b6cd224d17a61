"""Weight carry from the JAX package's SlowFast variables to this port.

``state_dict_from_jax(variables)`` takes the JAX model's
``{'params': ..., 'batch_stats': ...}`` tree (nested dicts of numpy arrays)
and returns the port's ``state_dict``: conv kernels DHWIO -> OIDHW, dense
(I, O) -> (O, I), BN scale/bias/mean/var -> weight/bias/running_mean/
running_var. The module-name map is this package's own copy of the
pytorchvideo key grammar (the JAX package's ``models/torch_convert.py``).
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

# res_unit Sequential indices (my_slowfast.py:228-236).
_RES_UNIT = {"res_unit_conv1": "0", "res_unit_norm1": "2",
             "res_unit_conv2": "3", "res_unit_norm2": "5",
             "res_unit_conv3": "6"}
_FUSE = {"conv_fast_to_slow": "conv_fast_to_slow.0", "norm": "norm.0",
         "residual_conv": "residual.0",
         **{k: f"res_unit.{v}" for k, v in _RES_UNIT.items()}}


def torch_module_name(path: Tuple[str, ...]) -> str:
    """JAX module path -> the port's module name (pytorchvideo grammar)."""
    if path == ("head", "proj"):
        return "blocks.6.proj"
    m = re.fullmatch(r"blocks_(\d)_pathway_(\d)", path[0])
    if m:
        prefix = f"blocks.{m.group(1)}.multipathway_blocks.{m.group(2)}"
        if len(path) == 2 and path[1] in ("conv", "norm"):  # stem
            return f"{prefix}.{path[1]}"
        rb = re.fullmatch(r"res_block_(\d+)", path[1])
        if rb and len(path) == 3 and path[2] in ("branch1_conv", "branch1_norm"):
            return f"{prefix}.res_blocks.{rb.group(1)}.{path[2]}"
        if rb and len(path) == 4 and path[2] == "branch2":
            return f"{prefix}.res_blocks.{rb.group(1)}.branch2.{path[3]}"
    m = re.fullmatch(r"blocks_(\d)_fuse", path[0])
    if m and len(path) == 2 and path[1] in _FUSE:
        return f"blocks.{m.group(1)}.multipathway_fusion.{_FUSE[path[1]]}"
    raise KeyError(f"no port module for JAX path {'/'.join(path)}")


def _leaf(name: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    if name == "kernel":
        if arr.ndim == 5:
            return "weight", np.transpose(arr, (4, 3, 0, 1, 2))  # DHWIO -> OIDHW
        if arr.ndim == 2:
            return "weight", np.transpose(arr, (1, 0))  # (I, O) -> (O, I)
        raise ValueError(f"kernel of rank {arr.ndim}")
    return {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}[name], arr


def state_dict_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Dict, path: Tuple[str, ...]) -> None:
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, path + (key,))
                continue
            name, arr = _leaf(key, np.asarray(val))
            out[f"{torch_module_name(path)}.{name}"] = torch.from_numpy(
                np.ascontiguousarray(arr, dtype=np.float32))

    for coll in ("params", "batch_stats"):
        walk(dict(variables.get(coll, {})), ())
    return out
