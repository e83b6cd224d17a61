"""Best-accuracy checkpoints in the port's own format.

  * save: ``<ROOT>/logs/checkpoints/<model-name>/acc%.3f_e%d.ckpt``, a
    ``torch.save`` of the model's state_dict (the reference's naming,
    train.py:185-196); skipped in DEBUG.
  * load: tier 1, the latest own checkpoint (sorted glob, so the highest
    accuracy wins); tier 2, the slowfast-HTAH checkpoint for a slowfast part
    stream (train.py:198-214); tier 3, the Kinetics warm start from a
    pytorchvideo state_dict (``load_torch_warmstart``, train.py:93-111).

Flax msgpack checkpoints of the JAX package cannot be read here; weights
cross over through ``models/convert.state_dict_from_jax``.
"""

from __future__ import annotations

import glob
import pickle
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

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


def load_checkpoint(cfg, model: nn.Module,
                    torch_warmstart: Optional[Path] = None) -> Optional[Path]:
    """Restore tier 1, tier 2 or (given an existing ``torch_warmstart``)
    tier 3 into ``model``; returns the file used."""
    path = _latest(str(ckpt_dir(cfg) / "*.ckpt"))
    if path is not None:
        print(f"loading checkpoint from {path}")
    else:
        htah = _latest(str(ckpt_dir(cfg).parent / "slowfast-HTAH" / "*.ckpt"))
        if htah is not None and "slowfast" in cfg.MODEL.NAME:
            print(f"warning: no checkpoint found, using HTAH checkpoint {htah}")
            path = htah
    if path is None:
        if torch_warmstart is not None and Path(torch_warmstart).exists():
            print(f"warm-starting from torch checkpoint {torch_warmstart}")
            load_torch_warmstart(Path(torch_warmstart), model)
            return Path(torch_warmstart)
        print("warning: no checkpoint found")
        return None
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state)
    return path


def delete_mismatch(state_dict: Dict) -> Dict:
    for key in MISMATCH_LAYERS:
        state_dict.pop(key, None)
    return state_dict


def load_torch_warmstart(path: Path, model: nn.Module) -> List[str]:
    """Kinetics warm start (tier 3): the file the JAX package's
    ``load_torch_warmstart`` reads, a pickle of {'model_state': state_dict}
    or of a raw state_dict (pytorchvideo names). The mismatched layers are
    deleted, keys the model does not have are ignored, and the rest is loaded
    non-strictly. The file is unpickled, so it must come from a trusted
    source. Returns the keys loaded."""
    with Path(path).open("rb") as f:
        obj = pickle.load(f)
    state_dict = obj.get("model_state", obj) if isinstance(obj, dict) else obj
    delete_mismatch(state_dict)
    own = model.state_dict()
    kept = {k: torch.as_tensor(np.asarray(v)) for k, v in state_dict.items() if k in own}
    model.load_state_dict(kept, strict=False)
    return sorted(kept)
