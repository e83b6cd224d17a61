"""Stream-parallel training: one crop stream per device group.

Port of the JAX package's ``engine/parallel_streams.py``. The reference
trains its part streams one after another on one GPU (train.py:405-419); the
streams share nothing (crop folders, checkpoints), so each gets a group of
devices and the streams train at once, one host thread per stream:

  * a group of one device trains its stream in that thread, with a
    ``Trainer`` on the group's device;
  * a group of more than one device trains its stream data-parallel over
    the group: the thread starts one rank per device, each the CLI's
    ``train`` under the ``torch.distributed`` environment
    (``parallel.multihost.launch_ranks``), with ``CUDA_VISIBLE_DEVICES``
    set to the group's cards.

With more streams than groups, groups are reused round-robin and their
streams share the devices; on a machine with one card every group holds it.
Every thread builds its stream's trainer before any of them trains: each
stream restores the checkpoints that existed when the call began, never one
a sibling saves meanwhile (a stream without its own checkpoint would
otherwise warm-start from slowfast-HTAH's, or not, by a race).
"""

from __future__ import annotations

import os
import re
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..config.defaults import load_model_cfg
from ..parallel.multihost import launch_ranks
from ..utils.cuda import resolve_device

ROOT = Path(__file__).resolve().parent.parent.parent


def assign_device_groups(devices: Sequence, n_streams: int,
                         devices_per_stream: int) -> List[List]:
    """Contiguous, disjoint device groups, one per stream (round-robin reuse
    only when streams exceed capacity: groups then time-share a device set)."""
    n = len(devices)
    per = max(1, devices_per_stream)
    capacity = max(1, n // per)
    groups = []
    for s in range(n_streams):
        slot = s % capacity
        groups.append(list(devices[slot * per:(slot + 1) * per]))
    return groups


def visible_devices(device=None) -> List[torch.device]:
    """Every CUDA card, or ``[cpu]`` when ``device`` is "cpu"; raises
    without a card unless the CPU is asked for."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def train_data_parallel(name: str, cfg_overrides: Sequence[str], group: Sequence,
                        timeout_s: Optional[float] = None) -> float:
    """Trains config ``name`` data-parallel over the devices of ``group``:
    one process per device, each ``python -m video_classification_tpu_torch
    train name --opts ...`` as one rank (``parallel.multihost.launch_ranks``).
    Returns rank 0's best accuracy; raises with a failed rank's error
    output, or ``TimeoutError`` after ``timeout_s``."""
    devs = [torch.device(d) for d in group]
    env = dict(os.environ)
    if devs[0].type == "cpu":
        env["VCT_PLATFORM"] = "cpu"
    else:
        env["CUDA_VISIBLE_DEVICES"] = ",".join(str(d.index or 0) for d in devs)
    argv = ["-m", "video_classification_tpu_torch", "train", name, "--opts", *cfg_overrides]
    outs = launch_ranks(lambda r: argv, len(devs), env=env, cwd=ROOT, timeout_s=timeout_s)
    for rank, (rc, out, err) in enumerate(outs):
        if rc != 0:
            raise RuntimeError(f"{name}: rank {rank} of {len(devs)} exited {rc}: "
                               f"{err.strip()[-2000:]}")
    found = re.findall(rf"^{re.escape(name)}: best acc (\S+)$", outs[0][1], re.M)
    if not found:
        raise RuntimeError(f"{name}: rank 0 printed no best accuracy")
    return float(found[-1])


def train_streams_parallel(
    model_names: Sequence[str],
    cfg_overrides: Optional[List[str]] = None,
    devices_per_stream: int = 1,
    cfg_factory: Optional[Callable] = None,
    trainer_factory: Optional[Callable] = None,
    devices: Optional[Sequence] = None,
    device=None,
) -> Dict[str, float]:
    """Train every stream concurrently; returns {name: best accuracy}.

    ``devices`` defaults to ``visible_devices(device)``. ``cfg_factory(name)
    -> cfg`` overrides the yaml loading and ``trainer_factory(cfg, device)
    -> trainer with .train()`` the ``Trainer`` (tests); both apply to the
    groups of one device. A group of more devices trains the named config
    with ``cfg_overrides`` through ``train_data_parallel``."""
    overrides = list(cfg_overrides or [])
    if trainer_factory is None:
        from .trainer import Trainer

        def trainer_factory(cfg, dev):
            return Trainer(cfg, device=dev, distributed=False)
    if cfg_factory is None:
        def cfg_factory(name):
            return load_model_cfg(name, overrides=overrides)

    devices = list(devices) if devices is not None else visible_devices(device)
    groups = assign_device_groups(devices, len(model_names), devices_per_stream)
    results: Dict[str, float] = {}
    errors: Dict[str, BaseException] = {}
    built = threading.Barrier(len(model_names))

    def run(name: str, group):
        trainer = None
        try:
            if len(group) == 1:
                trainer = trainer_factory(cfg_factory(name), group[0])
        except BaseException as e:  # reported after the join
            errors[name] = e
        built.wait()  # every stream's trainer built (or failed) before any trains
        if name in errors:
            return
        try:
            if trainer is not None:
                results[name] = float(trainer.train())
            else:
                results[name] = train_data_parallel(name, overrides, group)
        except BaseException as e:
            errors[name] = e

    threads = [threading.Thread(target=run, args=(nm, g), name=f"stream-{nm}")
               for nm, g in zip(model_names, groups)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # Which streams finished and which died, not only the first failure.
    for name in model_names:
        if name in results:
            print(f"stream {name}: done, best acc {results[name]:.4f}")
        elif name in errors:
            print(f"stream {name}: FAILED: {errors[name]!r}")
    if errors:
        detail = "; ".join(f"{n}: {e!r}" for n, e in errors.items())
        err = RuntimeError(f"{len(errors)}/{len(model_names)} streams failed ({detail}); "
                           f"completed: {sorted(results)}")
        raise err from next(iter(errors.values()))
    return results
