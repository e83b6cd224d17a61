"""Weight carry from the JAX package's DensePoseRCNN variables to this port.

``state_dict_from_jax(variables)`` takes the JAX detector's
``{'params': ..., 'batch_stats': ...}`` tree (nested dicts of numpy arrays)
and returns the port's ``state_dict``, whose names are detectron2's. It is
the inverse of the JAX package's ``detect/d2_convert.d2_to_flax``: conv
kernels HWIO -> OIHW, dense (I, O) -> (O, I), the box head's fc1 re-laid
from the channels-last (H, W, C) flatten back to detectron2's (C, H, W),
deconv kernels transposed back to (I, O, kH, kW) and un-flipped, and norm
scale/bias/mean/var -> weight/bias/running_mean/running_var. Any path it
does not know raises.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

_RPN = {"conv": "conv", "objectness": "objectness_logits",
        "deltas": "anchor_deltas"}
_NORM_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
                "var": "running_var"}


def _backbone_name(path: Tuple[str, ...]) -> str:
    if path == ("stem_conv",):
        return "backbone.bottom_up.stem.conv1"
    if path == ("stem_norm",):
        return "backbone.bottom_up.stem.conv1.norm"
    if len(path) == 1 and re.fullmatch(r"fpn_(lateral|output)[2-5]", path[0]):
        return f"backbone.{path[0]}"
    m = re.fullmatch(r"res([2-5])_(\d+)", path[0])
    if m and len(path) == 2:
        block = f"backbone.bottom_up.res{m.group(1)}.{m.group(2)}"
        if path[1] == "downsample_conv":
            return f"{block}.shortcut"
        if path[1] == "downsample_norm":
            return f"{block}.shortcut.norm"
        c = re.fullmatch(r"(conv|bn)([1-3])", path[1])
        if c:
            return f"{block}.conv{c.group(2)}" + (".norm" if c.group(1) == "bn" else "")
    raise KeyError


def _aspp_name(name: str) -> str:
    if name == "aspp_project":
        return "project.0"
    if name == "aspp_pool_conv":
        return "convs.4.1"
    if name == "aspp_pool_gn":
        return "convs.4.2"
    m = re.fullmatch(r"aspp_(conv|gn)([1-4])", name)
    if m:
        return f"convs.{int(m.group(2)) - 1}.{0 if m.group(1) == 'conv' else 1}"
    raise KeyError


def torch_module_name(path: Tuple[str, ...]) -> str:
    """JAX module path -> the port's (detectron2's) module name."""
    try:
        top, rest = path[0], path[1:]
        if top == "backbone":
            return _backbone_name(rest)
        if top == "rpn" and len(rest) == 1:
            return f"proposal_generator.rpn_head.{_RPN[rest[0]]}"
        if top == "box_head" and len(rest) == 1:
            return {"fc1": "roi_heads.box_head.fc1", "fc2": "roi_heads.box_head.fc2",
                    "cls": "roi_heads.box_predictor.cls_score",
                    "box": "roi_heads.box_predictor.bbox_pred"}[rest[0]]
        if top == "decoder" and len(rest) == 1:
            if rest[0] == "predictor":
                return "roi_heads.decoder.predictor"
            m = re.fullmatch(r"p([2-5])_conv(\d)", rest[0])
            if m:  # Sequential(conv[, up]...): convs at even indices
                return f"roi_heads.decoder.p{m.group(1)}.{2 * int(m.group(2))}"
        if top == "densepose_head":
            if len(rest) == 2 and rest[0] == "ASPP":
                return f"roi_heads.densepose_head.ASPP.{_aspp_name(rest[1])}"
            m = re.fullmatch(r"(conv|gn)([1-8])", rest[0]) if len(rest) == 1 else None
            if m:
                return (f"roi_heads.densepose_head.body_conv_fcn{m.group(2)}"
                        + (".norm" if m.group(1) == "gn" else ""))
        if top == "densepose_predictor" and len(rest) == 1 and rest[0] in (
                "ann_index_lowres", "index_uv_lowres", "u_lowres", "v_lowres"):
            return f"roi_heads.densepose_predictor.{rest[0]}"
    except KeyError:
        pass
    raise KeyError(f"no port module for JAX path {'/'.join(path)}")


def _weight(path: Tuple[str, ...], kernel: np.ndarray) -> np.ndarray:
    if path[0] == "densepose_predictor":  # pre-flipped (kH, kW, I, O)
        return np.transpose(kernel, (2, 3, 0, 1))[:, :, ::-1, ::-1]
    if kernel.ndim == 4:
        return np.transpose(kernel, (3, 2, 0, 1))  # HWIO -> OIHW
    if path == ("box_head", "fc1"):  # (7*7*C, O), HWC flatten -> (O, C*7*7)
        out = kernel.shape[1]
        return (kernel.reshape(7, 7, -1, out).transpose(3, 2, 0, 1)
                .reshape(out, -1))
    if kernel.ndim == 2:
        return kernel.T
    raise ValueError(f"kernel of rank {kernel.ndim} at {'/'.join(path)}")


def state_dict_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Dict, path: Tuple[str, ...]) -> None:
        for key, val in node.items():
            if isinstance(val, dict) or hasattr(val, "items"):
                walk(val, path + (key,))
                continue
            arr = np.asarray(val, np.float32)
            if key == "kernel":
                name, arr = "weight", _weight(path, arr)
            elif key in _NORM_LEAVES:
                name = _NORM_LEAVES[key]
            else:
                raise KeyError(f"unknown leaf {key} at {'/'.join(path)}")
            out[f"{torch_module_name(path)}.{name}"] = torch.from_numpy(
                np.ascontiguousarray(arr))

    for coll in ("params", "batch_stats"):
        walk(dict(variables.get(coll, {})), ())
    return out
