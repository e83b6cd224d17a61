"""Multi-process execution on ``torch.distributed``.

Port of the JAX package's ``parallel/multihost.py``. The JAX package runs one
SPMD program per process over a global device mesh; here every process is one
rank of a ``torch.distributed`` process group with one device, and the world
is the data axis. The entry points are the CLI's ``train``, ``train-parts``,
``train-parallel`` and ``eval``, run once per rank, e.g. by ``torchrun``:

    torchrun --nproc-per-node 2 -m video_classification_tpu_torch train slowfast-HTAH

The CLI calls :func:`initialize_distributed` first. The ``Trainer`` then
feeds each rank its contiguous rows of every global batch
(``data/dataset.train_batches_for_host``), takes BatchNorm's moments and the
loss over the global batch, all-reduces the gradient, shards the eval's
video decode (``sharded_eval_plan``), and writes checkpoints on rank 0 only.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from datetime import timedelta
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def initialize_distributed(device: Optional[str] = None,
                           timeout_s: float = 1800.0) -> bool:
    """``torch.distributed.init_process_group`` from the environment
    ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``).

    Returns True if a process group exists afterwards. A no-op (False)
    without that environment, and safe to call twice. ``device`` "cpu" (the
    CLI's ``VCT_PLATFORM=cpu``) keeps the ranks on the CPU; otherwise rank
    r takes ``cuda:LOCAL_RANK % device_count`` as its current device. The
    backend is NCCL when every rank of the host has a card of its own, and
    gloo otherwise: on the CPU, or when ranks share a card (NCCL refuses
    two ranks on one device). Prints the backend chosen."""
    if dist.is_available() and dist.is_initialized():
        return True
    if not all(os.environ.get(k) for k in ENV) or not dist.is_available():
        return False
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ["LOCAL_RANK"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    on_cuda = device != "cpu" and torch.cuda.is_available()
    backend = "gloo"
    if on_cuda:
        count = torch.cuda.device_count()
        torch.cuda.set_device(local_rank % count)
        if local_world <= count:
            backend = "nccl"
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    where = f"cuda:{torch.cuda.current_device()}" if on_cuda else "cpu"
    print(f"distributed: rank {rank}/{world} (local {local_rank}/{local_world}) on "
          f"{where}, backend {backend}", flush=True)
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def host_batch_indices(order: Sequence[int], global_batch: int,
                       n_processes: Optional[int] = None,
                       index: Optional[int] = None,
                       drop_last: bool = True) -> List[List[int]]:
    """Split an epoch's (already shuffled) index order into this rank's rows.

    Every rank must see the same ``order`` (same shuffle seed) and the same
    number of steps; rank p takes the contiguous sub-block p of each global
    batch."""
    p = n_processes if n_processes is not None else process_count()
    i = index if index is not None else process_index()
    if global_batch % p:
        raise ValueError(f"global batch {global_batch} does not divide by {p} ranks")
    per_host = global_batch // p
    out = []
    for start in range(0, len(order), global_batch):
        block = list(order[start:start + global_batch])
        if len(block) < global_batch:
            if drop_last:
                break
            # Tile the remainder up to the full batch (a single slice-append
            # can only double it, which would give ranks unequal shards).
            reps = -(-global_batch // len(block))
            block = (block * reps)[:global_batch]
        out.append(block[i * per_host:(i + 1) * per_host])
    return out


def stages_through_host(t: torch.Tensor, group=None) -> bool:
    """Whether a collective other than all-reduce and broadcast must copy
    ``t`` to the host: gloo implements only those two for CUDA tensors."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """(n, ...) on every rank -> (world * n, ...) in rank order, on ``t``'s
    device. Under gloo a CUDA tensor is gathered through the host (gloo has
    no all_gather for CUDA tensors)."""
    src = t.cpu() if stages_through_host(t, group) else t
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src.contiguous(), group=group)
    return torch.cat(parts).to(t.device)


def launch_ranks(argv: Callable[[int], Sequence[str]], n: int, env: Optional[dict] = None,
                 cwd=None, timeout_s: Optional[float] = None) -> List[Tuple[int, str, str]]:
    """Runs ``python argv(r)`` for ranks r = 0..n-1 with the environment
    ``torchrun`` sets (``env`` or this process's, plus a free local port),
    and waits for all of them. Returns [(returncode, stdout, stderr)] in
    rank order. If they have not all ended within ``timeout_s`` seconds,
    every rank is killed and ``TimeoutError`` raised (a hung rendezvous
    never outlives its caller)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = dict(os.environ if env is None else env, MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port), WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n))
    procs = [subprocess.Popen([sys.executable, *argv(r)], cwd=cwd, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env={**base, "RANK": str(r), "LOCAL_RANK": str(r)})
             for r in range(n)]
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    outs = []
    try:
        for p in procs:
            left = None if deadline is None else max(deadline - time.monotonic(), 0.0)
            out, err = p.communicate(timeout=left)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        raise TimeoutError(f"{n} ranks of {list(argv(0))} did not end within {timeout_s} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs
