"""Batch padding for data parallelism over ranks.

Port of the JAX package's ``parallel/mesh.py`` padding helpers. The JAX
package shards the batch over a device mesh (``TPU.MESH_SHAPE`` /
``MESH_AXES``, not ported); here the data axis is the ``torch.distributed``
world, one rank per card, so the size a batch must divide is the world size.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def pad_batch_for_mesh(batch: Dict, size: int) -> Tuple[Dict, int]:
    """Pad a batch so its leading dim divides ``size`` (the world size).

    Returns (padded batch, real count). Padding repeats row 0 (numpy arrays
    stay numpy, tensors stay tensors on their device); callers mask by the
    real count (eval) or avoid ragged batches (train drops the last batch,
    train.py:164)."""
    n = next(iter(batch.values())).shape[0]
    target = pad_to_multiple(n, size)
    if target == n:
        return batch, n

    def pad(x):
        if isinstance(x, torch.Tensor):
            return torch.cat([x, x[:1].expand(target - n, *x.shape[1:])])
        x = np.asarray(x)
        return np.concatenate([x, np.repeat(x[:1], target - n, axis=0)], axis=0)

    return {k: pad(v) for k, v in batch.items()}, n
