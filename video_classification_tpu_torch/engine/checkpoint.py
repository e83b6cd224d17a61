"""Best-accuracy checkpoints; the port reads the JAX package's too.

  * save: ``<ROOT>/logs/checkpoints/<model-name>/acc%.3f_e%d.ckpt``, a
    ``torch.save`` of the model's state_dict (the reference's naming,
    train.py:185-196); skipped in DEBUG.
  * load: tier 1, the latest own checkpoint (sorted glob, so the highest
    accuracy wins); tier 2, the slowfast-HTAH checkpoint for a slowfast part
    stream (train.py:198-214); tier 3, the Kinetics warm start from a
    pytorchvideo state_dict (``load_torch_warmstart``, train.py:93-111).

Tiers 1 and 2 read each file in its own format (``read_state_dict``): the
port's ``torch.save`` zip, or the flax msgpack file that the JAX package's
``save_checkpoint`` writes at the same path, converted by
``models/convert.flax_to_torch``. A root may hold files of both packages;
the sorted glob picks the highest accuracy whichever wrote it. Both load
strictly: a missing or extra key raises and names the key. The JAX
package's orbax directories are refused (reading them needs tensorstore).
"""

from __future__ import annotations

import glob
import pickle
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from ..models.convert import MISMATCH_LAYERS, delete_mismatch, flax_to_torch  # noqa: F401
from ..utils import flax_msgpack

_ZIP_MAGIC = b"PK\x03\x04"


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


def read_state_dict(path: Path) -> Dict[str, torch.Tensor]:
    """The state_dict in ``path``: a ``torch.save`` zip of the port, or a
    flax msgpack file of the JAX package (``{'params', 'batch_stats'}`` of
    a stream, or the bare ``{'weight', 'bias'}`` of the sparse fusion)."""
    path = Path(path)
    if path.is_dir():
        raise ValueError(
            f"{path} is an orbax checkpoint directory (the JAX package's "
            "save_checkpoint(backend='orbax')); the port reads the msgpack backend's "
            "files, save_checkpoint's default. Reading orbax needs tensorstore.")
    with path.open("rb") as f:
        head = f.read(4)
    if head == _ZIP_MAGIC:
        return torch.load(path, map_location="cpu", weights_only=True)
    if head and flax_msgpack.is_map_header(head[0]):
        tree = flax_msgpack.from_bytes(path.read_bytes())
        return flax_to_torch(tree if "params" in tree else {"params": tree})
    raise ValueError(f"{path} is neither a torch.save zip nor a flax msgpack file")


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
    model.load_state_dict(read_state_dict(path))
    return path


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
