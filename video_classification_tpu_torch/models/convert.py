"""Weight carry from the JAX package's model variables to this port.

``state_dict_from_jax(variables)`` takes a JAX model's ``{'params': ...,
'batch_stats': ...}`` tree (nested dicts of numpy arrays) and returns the
port's ``state_dict``: conv kernels DHWIO -> OIDHW and HWIO -> OIHW, dense
(I, O) -> (O, I), BN scale/bias/mean/var -> weight/bias/running_mean/
running_var. The module-name map is this package's own copy of the key
grammars of the JAX package's ``models/torch_convert.py``, one per model,
told apart by their top-level names (which no two share):

  * SlowFast (``blocks_*``, ``head``): pytorchvideo's ``slowfast`` grammar;
  * Res3D (``stem``, ``stage_*``, ``proj``): pytorchvideo's ``slow_r50``;
  * ResNet50_2D (``conv1``, ``bn1``, ``layer*_*``, ``fc``): torchvision's
    ``resnet50``;
  * SparseModel (``weight`` (C, P) and ``bias`` at the root): as they are.
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


_RES3D_BLOCK = {"stem": "0", "stage_1": "1", "stage_2": "2", "stage_3": "3",
                "stage_4": "4"}
_RES2D_SUB = {"downsample_conv": "downsample.0", "downsample_norm": "downsample.1"}


def _res_block_name(prefix: str, path: Tuple[str, ...]) -> str:
    """``res_block_{j}`` paths (``path`` from there on) below ``prefix``."""
    rb = re.fullmatch(r"res_block_(\d+)", path[0]) if path else None
    if rb and len(path) == 2 and path[1] in ("branch1_conv", "branch1_norm"):
        return f"{prefix}.res_blocks.{rb.group(1)}.{path[1]}"
    if rb and len(path) == 3 and path[1] == "branch2":
        return f"{prefix}.res_blocks.{rb.group(1)}.branch2.{path[2]}"
    raise KeyError(f"no port module for JAX path {'/'.join(path)}")


def torch_module_name(path: Tuple[str, ...]) -> str:
    """JAX module path -> the port's module name ("" for the root)."""
    if path == ():  # SparseModel's weight and bias
        return ""
    if path == ("head", "proj"):
        return "blocks.6.proj"
    if path == ("proj",):  # Res3D's head
        return "blocks.5.proj"
    if path[0] in _RES3D_BLOCK:
        prefix = f"blocks.{_RES3D_BLOCK[path[0]]}"
        if path[0] == "stem" and len(path) == 2 and path[1] in ("conv", "norm"):
            return f"{prefix}.{path[1]}"
        return _res_block_name(prefix, path[1:])
    if path in (("conv1",), ("bn1",), ("fc",)):  # ResNet50_2D's stem and head
        return path[0]
    m = re.fullmatch(r"layer(\d)_(\d+)", path[0])
    if m and len(path) == 2:
        return f"layer{m.group(1)}.{m.group(2)}.{_RES2D_SUB.get(path[1], path[1])}"
    m = re.fullmatch(r"blocks_(\d)_pathway_(\d)", path[0])
    if m:
        prefix = f"blocks.{m.group(1)}.multipathway_blocks.{m.group(2)}"
        if len(path) == 2 and path[1] in ("conv", "norm"):  # stem
            return f"{prefix}.{path[1]}"
        return _res_block_name(prefix, path[1:])
    m = re.fullmatch(r"blocks_(\d)_fuse", path[0])
    if m and len(path) == 2 and path[1] in _FUSE:
        return f"blocks.{m.group(1)}.multipathway_fusion.{_FUSE[path[1]]}"
    raise KeyError(f"no port module for JAX path {'/'.join(path)}")


def _leaf(name: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    if name == "kernel":
        if arr.ndim == 5:
            return "weight", np.transpose(arr, (4, 3, 0, 1, 2))  # DHWIO -> OIDHW
        if arr.ndim == 4:
            return "weight", np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW
        if arr.ndim == 2:
            return "weight", np.transpose(arr, (1, 0))  # (I, O) -> (O, I)
        raise ValueError(f"kernel of rank {arr.ndim}")
    return {"scale": "weight", "weight": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}[name], arr


def state_dict_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Dict, path: Tuple[str, ...]) -> None:
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, path + (key,))
                continue
            name, arr = _leaf(key, np.asarray(val))
            module = torch_module_name(path)
            out[f"{module}.{name}" if module else name] = torch.from_numpy(
                np.ascontiguousarray(arr, dtype=np.float32))

    for coll in ("params", "batch_stats"):
        walk(dict(variables.get(coll, {})), ())
    return out


def raft_state_dict_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    """The JAX package's RAFT variables ``{'params', 'batch_stats'}`` (numpy)
    -> the port's ``RAFT`` state_dict, in torchvision's key grammar: the
    layout transforms of the JAX ``raft_torch_to_flax`` reversed (conv HWIO
    -> OIHW, BatchNorm scale/bias/mean/var -> weight/bias/running_mean/
    running_var, ``num_batches_tracked`` 0). The motion encoder's first conv
    takes the shape it has in ``variables`` (fewer pyramid levels on a small
    input)."""
    from .raft_convert import flax_path, raft_key_shapes

    out: Dict[str, torch.Tensor] = {}
    for key in raft_key_shapes():
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            out[key] = torch.zeros((), dtype=torch.int64)
            continue
        path, is_norm = flax_path(key)
        if is_norm:
            coll, name = {"weight": ("params", "scale"), "bias": ("params", "bias"),
                          "running_mean": ("batch_stats", "mean"),
                          "running_var": ("batch_stats", "var")}[leaf]
        else:
            coll, name = "params", {"weight": "kernel", "bias": "bias"}[leaf]
        node = variables[coll]
        for p in path:
            node = node[p]
        arr = np.asarray(node[name], np.float32)
        if name == "kernel":
            arr = np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out
