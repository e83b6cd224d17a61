"""Best-accuracy checkpoints in the port's own format.

  * save: ``<ROOT>/logs/checkpoints/<model-name>/acc%.3f_e%d.ckpt``, a
    ``torch.save`` of the model's state_dict (the reference's naming,
    train.py:185-196); skipped in DEBUG.
  * load: tier 1, the latest own checkpoint (sorted glob, so the highest
    accuracy wins); tier 2, the slowfast-HTAH checkpoint for a slowfast part
    stream (train.py:198-214). The Kinetics warm start (tier 3) belongs to
    the training slice.

Flax msgpack checkpoints of the JAX package cannot be read here; weights
cross over through ``models/convert.state_dict_from_jax``.
"""

from __future__ import annotations

import glob
from pathlib import Path
from typing import Optional

import torch
import torch.nn as nn


def ckpt_dir(cfg) -> Path:
    return Path(cfg.CHALEARN.ROOT, cfg.MODEL.LOGS, cfg.MODEL.CKPT_DIR, cfg.MODEL.NAME)


def save_checkpoint(cfg, model: nn.Module, epoch: int, acc: float) -> Optional[Path]:
    if cfg.DEBUG:
        return None
    d = ckpt_dir(cfg)
    d.mkdir(parents=True, exist_ok=True)
    path = d / ("acc%.3f_e%d.ckpt" % (acc, epoch))
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)
    return path


def _latest(pattern: str) -> Optional[Path]:
    files = sorted(glob.glob(pattern))
    return Path(files[-1]) if files else None


def load_checkpoint(cfg, model: nn.Module) -> Optional[Path]:
    """Restore tier 1 or tier 2 into ``model``; returns the file used."""
    path = _latest(str(ckpt_dir(cfg) / "*.ckpt"))
    if path is not None:
        print(f"loading checkpoint from {path}")
    else:
        htah = _latest(str(ckpt_dir(cfg).parent / "slowfast-HTAH" / "*.ckpt"))
        if htah is not None and "slowfast" in cfg.MODEL.NAME:
            print(f"warning: no checkpoint found, using HTAH checkpoint {htah}")
            path = htah
    if path is None:
        print("warning: no checkpoint found")
        return None
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state)
    return path
