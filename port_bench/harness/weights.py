"""Seeded random weights, made on the device in a few large calls.

A stream's state dict follows the reference network's names and shapes
(``reference.slowfast.SlowFast`` built on the meta device): convolution and
linear weights N(0, 1 / fan_in) (the program's own initialisation; He's
2 / fan_in drives the logits to ~1e4), the head's bias 0, BatchNorm's scale
U(0.5, 1.5), shift N(0, 0.1), running mean N(0, 0.1) and running variance
U(0.5, 1.5), so that every statistic of eval-mode BatchNorm is exercised.
Every value comes from one ``torch.Generator`` on ``device`` seeded with
``seed``: the same seed gives the same weights.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from ..reference.slowfast import SlowFast


def _kinds(model: torch.nn.Module):
    """(name, shape, kind) of every parameter and buffer, in state-dict order."""
    for name, t in model.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        if t.dim() >= 2:
            kind = "weight"
        elif ".proj." in name or name.startswith("proj."):
            kind = "zero"
        else:
            kind = {"weight": "scale", "bias": "shift", "running_mean": "shift",
                    "running_var": "scale"}[leaf]
        yield name, tuple(t.shape), kind


def stream_state_dict(classes: int, depth: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of one stream's SlowFast, float32 on ``device``."""
    with torch.device("meta"):
        layout = list(_kinds(SlowFast(classes, depth)))
    g = torch.Generator(device).manual_seed(int(seed))
    sizes = {k: sum(math.prod(s) for _, s, kind in layout if kind == k)
             for k in ("weight", "scale", "shift")}
    pools = {"weight": torch.randn(sizes["weight"], generator=g, device=device),
             "scale": torch.rand(sizes["scale"], generator=g, device=device) + 0.5,
             "shift": torch.randn(sizes["shift"], generator=g, device=device) * 0.1}
    at = {k: 0 for k in pools}
    out = {}
    for name, shape, kind in layout:
        if kind == "zero":
            out[name] = torch.zeros(shape, device=device)
            continue
        n = math.prod(shape)
        t = pools[kind][at[kind]:at[kind] + n].view(shape)
        at[kind] += n
        if kind == "weight":
            t = t * math.sqrt(1.0 / math.prod(shape[1:]))
        out[name] = t
    return out


def fusion_params(classes: int, parts: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """The sparse fusion's {'weight' (C, P), 'bias' (C,)}, drawn as the
    ChaLearn reference's ``SparseModel`` initialises its per-class
    ``nn.Linear(P, 1)`` (train_sparse.py:95-104, PyTorch's default): weight
    and bias U(-1/sqrt(P), 1/sqrt(P))."""
    g = torch.Generator(device).manual_seed(int(seed))
    bound = 1.0 / math.sqrt(parts)
    wb = (torch.rand((classes, parts + 1), generator=g, device=device) * 2.0 - 1.0) * bound
    return {"weight": wb[:, :parts].contiguous(), "bias": wb[:, parts].contiguous()}
