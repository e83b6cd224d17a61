"""Temporal sequence parallelism: the clip's T axis split over ranks.

Port of the JAX package's ``parallel/temporal.py``. JAX shards T over a
mesh axis under ``shard_map`` and swaps one-frame halos between neighbours
with ``lax.ppermute``; here each ``torch.distributed`` rank holds one
contiguous block of frames and swaps halos with point-to-point sends and
receives (``torch.distributed.batch_isend_irecv``).

Layouts are PyTorch's: activations (N, C, T, H, W), weights (Cout, Cin, kt,
kh, kw); the JAX functions take (N, T, H, W, C) and (kt, kh, kw, Cin, Cout).
Rank r of P holds frames [r * T / P, (r + 1) * T / P) of a T-frame clip
(``shard_t``, ``gather_t``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .multihost import all_gather_rows, stages_through_host


def halo_exchange_t(x_local: torch.Tensor, halo: int, group=None) -> torch.Tensor:
    """Append ``halo`` frames from each temporal neighbour: (N, C, Tl, H, W)
    -> (N, C, Tl + 2 * halo, H, W). The first and last ranks get zeros at
    the clip's ends (SAME convolution's padding). Every rank of ``group``
    must call it."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    # gloo sends and receives only CPU tensors: a CUDA tensor's halos go
    # through the host there.
    host = stages_through_host(x_local, group)
    edge = x_local.cpu() if host else x_local
    from_left = torch.zeros_like(edge[:, :, :halo])
    from_right = torch.zeros_like(from_left)
    ops = []
    if rank > 0:
        peer = dist.get_global_rank(group, rank - 1) if group is not None else rank - 1
        ops += [dist.P2POp(dist.isend, edge[:, :, :halo].contiguous(), peer, group),
                dist.P2POp(dist.irecv, from_left, peer, group)]
    if rank < world - 1:
        peer = dist.get_global_rank(group, rank + 1) if group is not None else rank + 1
        ops += [dist.P2POp(dist.isend, edge[:, :, -halo:].contiguous(), peer, group),
                dist.P2POp(dist.irecv, from_right, peer, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    dev = x_local.device
    return torch.cat([from_left.to(dev), x_local, from_right.to(dev)], dim=2)


def conv3d_temporal_sharded(x: torch.Tensor, w: torch.Tensor, group=None) -> torch.Tensor:
    """SAME, stride-1 conv3d of a clip whose T axis is split over the ranks
    of ``group``: ``x`` is this rank's (N, Cin, T / P, H, W) block, ``w``
    (Cout, Cin, kt, kh, kw) with odd kernels, the result this rank's block
    of the (N, Cout, T, H, W) output. Each block receives kt // 2 halo
    frames from each neighbour and is convolved locally, VALID in T. Every
    block must hold at least kt // 2 frames."""
    kt, kh, kw = w.shape[2:]
    halo = kt // 2
    if x.shape[2] < halo:
        raise ValueError(f"a block of {x.shape[2]} frames is shorter than the halo {halo}")
    xh = halo_exchange_t(x, halo, group) if halo else x
    return F.conv3d(xh, w, padding=(0, kh // 2, kw // 2))


def shard_t(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's block of a (N, C, T, H, W) clip's frames (T must divide
    by the world size)."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    t = x.shape[2]
    if t % world:
        raise ValueError(f"T = {t} does not divide by {world} ranks")
    return x[:, :, rank * t // world:(rank + 1) * t // world]


def gather_t(y_local: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's block, concatenated over T in rank order."""
    return all_gather_rows(y_local.movedim(2, 0).contiguous(), group).movedim(0, 2)
