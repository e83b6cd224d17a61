"""Where a full-width train step's device time goes, on one NVIDIA GPU.

    python3 -m video_classification_tpu_torch.profile_train
        [--backend {synthetic,online}] [--batch N] [--steps 10]

Trains slowfast-HTAH (SlowFast-R50, 249 classes, 192 px, CLIP_LEN 20,
bfloat16 compute, float32 master weights, seeded random weights) through
``engine/trainer.Trainer.train_step`` on one batch made by the chosen
backend: ``synthetic``, the in-memory clips of data/dataset.py (default
batch 16), or ``online``, 130-frame 240x320 synthetic videos through the
device preprocessing (K1 flow, K2 part extents; default batch 4). Three
warm-up steps, then ``--steps`` timed ones (host clock, synchronised at the
end), then one step under ``torch.profiler`` (for ``online``, with the
making of one batch of clips before it). Prints:

  * ms per step and train clips/s, the peak device memory;
  * the device time of the profiled step by kernel group: the libraries'
    convolutions and matrix products (cuDNN, cuBLAS, CUTLASS), the port's
    kernels (K1-K6 by name, as profile_serving groups them), and the rest
    of PyTorch's kernels; and by phase of the step (the ``record_function``
    ranges of ``Trainer.train_step`` around the launching host op, and
    autograd's engine for the backward): normalize + crop glue, forward
    with the loss, backward, Adam;
  * BatchNorm's share, by ablation: the step time with every BatchNorm
    made the identity, against the full step (same convolutions);
  * the busy share: the profiled device time over the unprofiled step time;
  * for ``online``: the seconds to make one batch of clips (stage times
    'detect', 'flow', 'crops') against the step, and the launches of each
    port kernel per batch.

Raises without CUDA, and for ``online`` when K1 or K2 did not launch or
K3-K6 did.
"""

from __future__ import annotations

import argparse
import json
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Optional

import torch
from torch.autograd import DeviceType

from .config import load_model_cfg
from .data.dataset import train_batches
from .engine.trainer import Trainer
from .models.layers import BatchNorm
from .pipeline.online import OnlineVideoDataset
from .profile_serving import GROUPS, _device_us, _group
from .utils.cuda import resolve_device
from .utils.profiling import StageTimer
from .utils.synthetic import coherent_motion_frames

PHASES = ("glue", "forward", "backward", "adam")


def train_cfg(root: str, batch: int, synthetic_videos: int = 0, debug: bool = True):
    """slowfast-HTAH at full width for training: ``batch`` clips per step,
    ``synthetic_videos`` > 0 selects the in-memory synthetic dataset (24
    frames each)."""
    cfg = load_model_cfg("slowfast-HTAH", ["CHALEARN.ROOT", root,
                                           "CHALEARN.BATCH_SIZE", str(batch)])
    cfg.DATA.SYNTHETIC_NUM_VIDEOS = synthetic_videos
    cfg.DATA.SYNTHETIC_SEQ_LEN = 24
    cfg.DEBUG = debug
    return cfg


def online_factory(videos: Dict[str, list], num_class: int, device, timer=None):
    """``dataset_factory`` of in-memory videos: ``videos[name_of_set]`` lists
    (rgb, depth) uint8 frames; video i of a set has label i % num_class + 1."""
    def make(cfg, name_of_set):
        vids = videos[name_of_set]
        labels = [(f"{name_of_set}/M_{i:05d}.avi", f"{name_of_set}/K_{i:05d}.avi",
                   i % num_class + 1) for i in range(len(vids))]
        return OnlineVideoDataset(cfg, name_of_set, labels=labels,
                                  videos=dict(enumerate(vids)), device=device, timer=timer)
    return make


def synthetic_video(seed: int, t: int = 130, h: int = 240, w: int = 320):
    """(rgb, depth) uint8 numpy frames of a coherent-motion video."""
    rgb = coherent_motion_frames(t, h, w, torch.Generator().manual_seed(seed))
    return rgb.numpy(), rgb.float().mean(-1, keepdim=True).to(torch.uint8).numpy()


@contextmanager
def batchnorm_as_identity():
    """Every BatchNorm returns its input (for the ablation timing only)."""
    forward = BatchNorm.forward
    BatchNorm.forward = lambda self, x: x
    try:
        yield
    finally:
        BatchNorm.forward = forward


def time_steps(trainer: Trainer, x, labels, steps: int, warmup: int = 3) -> float:
    """Seconds per train step: ``warmup`` steps, then ``steps`` timed ones,
    synchronised through the last loss."""
    for _ in range(warmup):
        trainer.train_step(x, labels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        m = trainer.train_step(x, labels)
    float(m["loss"])
    return (time.perf_counter() - t0) / steps


def profile(fn) -> Dict:
    """Device time of one call of ``fn`` under ``torch.profiler``: by kernel
    group, by phase of the train step, in all, and the top kernels.

    A ``record_function`` range also appears on the device timeline, as an
    annotation spanning its kernels; annotations (device events named like a
    host event) are not kernels. A kernel's phase is the ``train::`` range
    around the host op that launched it, or 'backward' under an autograd
    engine op (on CUDA those run on autograd's own thread, outside the
    ranges), else 'other'."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    averaged = prof.key_averages()
    host = {e.key for e in averaged if e.device_type == DeviceType.CPU}
    kernels = [e for e in averaged if e.device_type == DeviceType.CUDA
               and _device_us(e) > 0 and e.key not in host]
    groups = {g: {"ms": 0.0, "launches": 0} for g in GROUPS}
    for e in kernels:
        g = groups[_group(e.key)]
        g["ms"] += _device_us(e) / 1e3
        g["launches"] += int(e.count)
    phases = {p: 0.0 for p in PHASES + ("other",)}
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        phase, scope = "other", e
        while scope is not None:
            if scope.name.startswith("train::"):
                phase = scope.name.removeprefix("train::")
                break
            if scope.name.startswith("autograd::engine::"):
                phase = "backward"
                break
            scope = scope.cpu_parent
        phases[phase] += sum(k.duration for k in e.kernels if k.name not in host) / 1e3
    return {
        "device_ms": sum(g["ms"] for g in groups.values()),
        "groups": {g: {"ms": round(v["ms"], 3), "launches": v["launches"]}
                   for g, v in groups.items()},
        "phases_device_ms": {p: round(v, 3) for p, v in phases.items()},
        "top_kernels": [{"name": e.key[:90], "ms": round(_device_us(e) / 1e3, 3),
                         "launches": int(e.count)}
                        for e in sorted(kernels, key=_device_us, reverse=True)[:12]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("synthetic", "online"), default="synthetic")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    online = args.backend == "online"
    batch = args.batch or (4 if online else 16)
    # A root without checkpoints (the model keeps its seeded random weights);
    # DEBUG writes nothing there.
    root = str(Path(__file__).resolve().parent / "no_checkpoints")
    timer: Optional[StageTimer] = None
    factory = None
    if online:
        cfg = train_cfg(root, batch)
        timer = StageTimer(dev)
        videos = {"train": [synthetic_video(20 + i) for i in range(batch)],
                  "test": [synthetic_video(40)]}
        factory = online_factory(videos, int(cfg.CHALEARN.NUM_CLASS), dev, timer)
    else:
        cfg = train_cfg(root, batch, synthetic_videos=2 * batch)
    trainer = Trainer(cfg, device=dev, dataset_factory=factory)

    from .detect.nms import nms
    from .ops.component_extents import component_extents
    from .ops.flow_level import flow_level
    from .ops.label_components import label_components
    from .ops.sor_solve import sor_solve
    from .ops.warp import warp_bilinear

    wrappers = (flow_level, component_extents, nms, sor_solve, warp_bilinear,
                label_components)
    make_s = None

    def make_batch():
        nonlocal make_s
        if timer is not None:
            timer.seconds.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = next(train_batches(trainer.train_dataset, batch, seed=0))
        x = torch.as_tensor(b["x"]).to(dev)
        torch.cuda.synchronize()
        make_s = time.perf_counter() - t0
        return x, torch.as_tensor(b["label"]).to(dev)

    make_batch()  # warm-up: builds the kernels on first use
    for k in wrappers:
        k.launches = 0
    x, labels = make_batch()
    launches = {k.__name__: k.launches for k in wrappers}
    stages = dict(timer.seconds) if timer is not None else {}
    make_batch_s = make_s
    torch.cuda.reset_peak_memory_stats()
    step_s = time_steps(trainer, x, labels, args.steps)
    peak = torch.cuda.max_memory_allocated()
    step = profile(lambda: trainer.train_step(x, labels))
    clips = profile(make_batch) if online else None
    # Last: the identity BatchNorm leaves the weights meaningless.
    with batchnorm_as_identity():
        no_bn_s = time_steps(trainer, x, labels, args.steps)
    if online:
        for k in ("flow_level", "component_extents"):
            if launches[k] == 0:
                raise RuntimeError(f"making a batch of clips never launched {k}")
        for k in ("nms", "sor_solve", "warp_bilinear", "label_components"):
            if launches[k]:
                raise RuntimeError(f"making a batch of clips launched {k}")
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "backend": args.backend,
        "batch": batch,
        "compute_dtype": str(cfg.CUDA.COMPUTE_DTYPE),
        "step_ms": round(step_s * 1e3, 3),
        "train_clips_per_s": round(batch / step_s, 3),
        "peak_memory_gib": round(peak / 2**30, 3),
        "step_ms_batchnorm_identity": round(no_bn_s * 1e3, 3),
        "batchnorm_share_by_ablation": round(1 - no_bn_s / step_s, 4),
        "profiled_step_device_ms": round(step["device_ms"], 3),
        "device_busy_share": round(step["device_ms"] / 1e3 / step_s, 4),
        "step": step,
        "make_batch_s": round(make_batch_s, 4) if online else None,
        "make_batch_stage_s": {k: round(v, 4) for k, v in stages.items()},
        "make_batch_profile": clips,
        "launches_per_batch": launches if online else None,
    }, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
