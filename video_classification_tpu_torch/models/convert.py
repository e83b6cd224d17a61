"""Weight carry between the JAX package's model variables and this port.

``state_dict_from_jax(variables)`` (also ``flax_to_torch``, the JAX
package's name) takes a JAX model's ``{'params': ..., 'batch_stats': ...}``
tree (nested dicts of numpy arrays) and returns the port's ``state_dict``:
conv kernels DHWIO -> OIDHW and HWIO -> OIHW, dense (I, O) -> (O, I), BN
scale/bias/mean/var -> weight/bias/running_mean/running_var.
``torch_to_flax(state_dict)`` is its inverse. The module-name map is this
package's own copy of the key grammars of the JAX package's
``models/torch_convert.py``, one per model, told apart by their top-level
names (which no two share), so ``arch`` is checked but not needed:

  * SlowFast (``blocks_*``, ``head``): pytorchvideo's ``slowfast`` grammar;
  * Res3D (``stem``, ``stage_*``, ``proj``): pytorchvideo's ``slow_r50``;
  * ResNet50_2D (``conv1``, ``bn1``, ``layer*_*``, ``fc``): torchvision's
    ``resnet50``;
  * SparseModel (``weight`` (C, P) and ``bias`` at the root): as they are.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

ARCHS = ("slowfast", "res3d", "res2d", "sparse")

# The layers whose shapes differ from the Kinetics SlowFast (the stems and
# stage inputs take other channel counts, the head other classes):
# train.py:94-108, the list the JAX package's models/torch_convert.py keeps.
MISMATCH_LAYERS = [
    "blocks.0.multipathway_blocks.0.conv.weight",
    "blocks.0.multipathway_blocks.1.conv.weight",
    "blocks.6.proj.weight",
    "blocks.6.proj.bias",
    "blocks.1.multipathway_blocks.0.res_blocks.0.branch1_conv.weight",
    "blocks.1.multipathway_blocks.0.res_blocks.0.branch2.conv_a.weight",
    "blocks.2.multipathway_blocks.0.res_blocks.0.branch1_conv.weight",
    "blocks.2.multipathway_blocks.0.res_blocks.0.branch2.conv_a.weight",
    "blocks.3.multipathway_blocks.0.res_blocks.0.branch1_conv.weight",
    "blocks.3.multipathway_blocks.0.res_blocks.0.branch2.conv_a.weight",
    "blocks.4.multipathway_blocks.0.res_blocks.0.branch1_conv.weight",
    "blocks.4.multipathway_blocks.0.res_blocks.0.branch2.conv_a.weight",
]


def delete_mismatch(state_dict: Dict) -> Dict:
    for key in MISMATCH_LAYERS:
        state_dict.pop(key, None)
    return state_dict

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
    """A ``res_block_{j}`` path (``path[1:]``) below ``prefix``."""
    sub = path[1:]
    rb = re.fullmatch(r"res_block_(\d+)", sub[0]) if sub else None
    if rb and len(sub) == 2 and sub[1] in ("branch1_conv", "branch1_norm"):
        return f"{prefix}.res_blocks.{rb.group(1)}.{sub[1]}"
    if rb and len(sub) == 3 and sub[1] == "branch2":
        return f"{prefix}.res_blocks.{rb.group(1)}.branch2.{sub[2]}"
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
        return _res_block_name(prefix, path)
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
        return _res_block_name(prefix, path)
    m = re.fullmatch(r"blocks_(\d)_fuse", path[0])
    if m and len(path) == 2 and path[1] in _FUSE:
        return f"blocks.{m.group(1)}.multipathway_fusion.{_FUSE[path[1]]}"
    raise KeyError(f"no port module for JAX path {'/'.join(path)}")


_RES_BLOCK = re.compile(r"res_blocks\.(\d+)\.(branch1_conv|branch1_norm|branch2\.(\w+))")


def _res_block_path(rest: str) -> Optional[Tuple[str, ...]]:
    m = _RES_BLOCK.fullmatch(rest)
    if m is None:
        return None
    block = f"res_block_{m.group(1)}"
    return (block, "branch2", m.group(3)) if m.group(3) else (block, m.group(2))


def _guess_jax_path(module: str) -> Optional[Tuple[str, ...]]:
    fixed = {"": (), "blocks.6.proj": ("head", "proj"), "blocks.5.proj": ("proj",),
             "conv1": ("conv1",), "bn1": ("bn1",), "fc": ("fc",)}
    if module in fixed:
        return fixed[module]
    m = re.fullmatch(r"blocks\.(\d)\.multipathway_blocks\.(\d)\.(.+)", module)
    if m:
        base = f"blocks_{m.group(1)}_pathway_{m.group(2)}"
        rest = m.group(3)
    else:
        m = re.fullmatch(r"blocks\.(\d)\.multipathway_fusion\.(.+)", module)
        if m:
            sub = {v: k for k, v in _FUSE.items()}.get(m.group(2))
            return (f"blocks_{m.group(1)}_fuse", sub) if sub else None
        m = re.fullmatch(r"blocks\.(\d)\.(.+)", module)  # Res3D
        if m:
            base = {v: k for k, v in _RES3D_BLOCK.items()}.get(m.group(1), "")
            rest = m.group(2)
        else:
            m = re.fullmatch(r"layer(\d)\.(\d+)\.(.+)", module)  # ResNet50_2D
            if m is None:
                return None
            sub = {v: k for k, v in _RES2D_SUB.items()}.get(m.group(3), m.group(3))
            return (f"layer{m.group(1)}_{m.group(2)}", sub)
    if rest in ("conv", "norm"):  # a stem
        return (base, rest)
    block = _res_block_path(rest)
    return (base,) + block if block else None


def jax_module_path(module: str) -> Tuple[str, ...]:
    """The port's module name -> the JAX module path (the inverse of
    ``torch_module_name``)."""
    path = _guess_jax_path(module)
    try:
        if path is not None and torch_module_name(path) == module:
            return path
    except KeyError:
        pass
    raise KeyError(f"no JAX module for port module {module!r}")


def _as_numpy(val) -> np.ndarray:
    if isinstance(val, torch.Tensor):
        val = val.detach().cpu()
        return (val.float() if val.dtype == torch.bfloat16 else val).numpy()
    return np.asarray(val)


def _check_arch(arch: Optional[str]) -> None:
    if arch is not None and arch not in ARCHS:
        raise ValueError(f"arch must be one of {ARCHS}, got {arch!r}")


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


def state_dict_from_jax(variables: Dict, arch: Optional[str] = None
                        ) -> Dict[str, torch.Tensor]:
    """A JAX model's variables -> the port's float32 state_dict. A path that
    no port module has raises ``KeyError`` naming it."""
    _check_arch(arch)
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Dict, path: Tuple[str, ...]) -> None:
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, path + (key,))
                continue
            name, arr = _leaf(key, _as_numpy(val))
            module = torch_module_name(path)
            out[f"{module}.{name}" if module else name] = torch.from_numpy(
                np.ascontiguousarray(arr, dtype=np.float32))

    for coll in ("params", "batch_stats"):
        walk(dict(variables.get(coll, {})), ())
    return out


flax_to_torch = state_dict_from_jax


def torch_to_flax(state_dict: Dict, arch: str = "slowfast") -> Dict[str, Dict]:
    """The port's state_dict -> the JAX model's ``{'params': ...,
    'batch_stats': ...}`` of numpy arrays (the inverse of
    ``state_dict_from_jax``; ``num_batches_tracked`` is dropped). A key that
    no JAX module has raises ``KeyError`` naming it."""
    _check_arch(arch)
    variables: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for key, val in state_dict.items():
        module, _, leaf = key.rpartition(".")
        if leaf == "num_batches_tracked":
            continue
        arr = _as_numpy(val)
        coll = "params"
        if leaf in ("running_mean", "running_var"):
            coll, name = "batch_stats", leaf[len("running_"):]
        elif leaf == "bias" or (leaf == "weight" and not module):  # SparseModel's
            name = leaf
        elif leaf == "weight" and arr.ndim == 1:
            name = "scale"
        elif leaf == "weight":
            name = "kernel"
            arr = np.transpose(arr, {5: (2, 3, 4, 1, 0), 4: (2, 3, 1, 0),
                                     2: (1, 0)}[arr.ndim])
        else:
            raise KeyError(f"no JAX leaf for port key {key!r}")
        node = variables[coll]
        for p in jax_module_path(module):
            node = node.setdefault(p, {})
        node[name] = arr
    return variables


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
