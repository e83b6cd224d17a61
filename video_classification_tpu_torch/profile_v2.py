"""Where the v2 pipeline's time goes, on one NVIDIA GPU.

    python3 -m video_classification_tpu_torch.profile_v2
        [--provider {densepose,synthetic}] [--flow {variational,raft}]

Writes a raw fixture (``profile_preprocess.write_fixture``: one 130-frame
240x320 M_/K_ pair per set, train and test) through ``ArrayFrameIO``
(lossless ``.npy`` payloads: no JPEG or AVI coding), samples it, then runs
``v2-convert``'s four converters (``run_v2_convert``: flow, IUV, UV videos,
part boxes) three times, each on a fresh copy: once cold, once timed
(seconds per converter, synchronised, and per M_ video), once under
``torch.profiler``. The flow is the variational one (K1) or RAFT
(raft_large, 12 iterations, float32, weights from the synthesized
torchvision-grammar state_dict loaded through ``models/raft_convert``); the
provider is the DensePose R-CNN at detectron2's test budget with seeded
random weights (``profile_preprocess.random_provider``; K3) or the synthetic
one. Then ``V2Trainer`` at full width (SlowFast-R50 with (5, 2) pathways,
249 classes, 192 px, CLIP_LEN 20, bfloat16, SGD) takes 10 timed steps at
batch 16 on one batch of random clips after three warm-up steps.

Prints one JSON object: converter seconds and per video, the flow's pairs/s,
K1-K6 and IRLS-kernel launches per video in the timed run, device kernel ms by group
(``profile_serving``'s groups), the top kernels, the busy share (profiled
kernel time over the timed run's seconds), and the train step's ms, clips/s
and peak memory. Raises without CUDA, and when a kernel of the chain did not
launch or another did.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time
from contextlib import nullcontext
from pathlib import Path
import torch

from .ops.flow import DEFAULT_PARAMS, FlowParams
from .pipeline import stages
from .pipeline.frame_io import ArrayFrameIO
from .pipeline.iuv_contract import SyntheticIUVProvider
from .profile_preprocess import (FRAMES, KERNELS, SETS, chain_cfg, check_launches,
                                 kernel_summary, random_provider, write_fixture)
from .models.raft_convert import write_synthesized_checkpoint
from .utils.cuda import BUILD_DIR, resolve_device
from .utils.profiling import StageTimer
from .v2 import (ConvertIuvPklToPartBox, ConvertIuvPklToUvVideo, ConvertVideoToFlow,
                 ConvertVideoToIUVPkl, V2Trainer)

CONVERTERS = ("flow", "iuv", "uv", "box")
TRAIN_BATCH = 16
TRAIN_STEPS = 10


def write_v2_fixture(root, io) -> None:
    """The raw fixture, sampled into 1_Sample (what v2-convert reads)."""
    write_fixture(root, io)
    stages.sample_data(chain_cfg(root), SETS)


def run_v2_convert(cfg, io, device, provider, method: str = "variational",
                   timer=None, raft_checkpoint=None,
                   flow_params: FlowParams = DEFAULT_PARAMS) -> None:
    """``v2-convert``'s four converters in order, each under ``timer``
    (``StageTimer``) as 'flow', 'iuv', 'uv' and 'box' when given."""
    timer = timer if timer is not None else (lambda name: nullcontext())
    flow = ConvertVideoToFlow(cfg, flow_params, method=method, raft_checkpoint=raft_checkpoint,
                              io=io, device=device)
    for name, conv in (("flow", flow), ("iuv", ConvertVideoToIUVPkl(cfg, provider, io=io)),
                       ("uv", ConvertIuvPklToUvVideo(cfg, io=io)),
                       ("box", ConvertIuvPklToPartBox(cfg, io=io, device=device))):
        with timer(name):
            conv.convert()


def v2_train_cfg(root, batch: int):
    """slowfast-HTAH's config (its LR) for V2Trainer at full width on
    ``root``: depth 50, 249 classes, INPUT_SIZE 192, CLIP_LEN 20, bfloat16,
    DEBUG (no checkpoint written)."""
    from .config import load_model_cfg

    cfg = load_model_cfg("slowfast-HTAH")
    cfg.CHALEARN.ROOT = str(root)
    cfg.CHALEARN.BATCH_SIZE = batch
    cfg.CHALEARN.CLIP_LEN = 20
    cfg.CHALEARN.NUM_CLASS = 249
    cfg.MODEL.DEPTH = 50
    cfg.MODEL.INPUT_SIZE = 192
    cfg.MODEL.NAME = "slowfast-v2"
    cfg.CUDA.COMPUTE_DTYPE = "bfloat16"
    cfg.DEBUG = True
    return cfg


def time_v2_train_steps(trainer, batch: int, steps: int):
    """(seconds per step, losses of every step, peak bytes) of ``steps``
    timed train steps on one batch of random uint8 clips (seed 0), after 3
    warm-up steps."""
    cfg = trainer.cfg
    size, t = int(cfg.MODEL.INPUT_SIZE), int(cfg.CHALEARN.CLIP_LEN)
    g = torch.Generator(trainer.device).manual_seed(0)
    x = torch.randint(0, 256, (batch, t, size, size, 7), generator=g, device=trainer.device,
                      dtype=torch.uint8)
    labels = torch.randint(0, int(cfg.CHALEARN.NUM_CLASS), (batch,), generator=g,
                           device=trainer.device)
    losses = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        losses.append(trainer.train_step(x, labels)["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(trainer.train_step(x, labels)["loss"])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    return step_s, [float(v) for v in losses], torch.cuda.max_memory_allocated()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--provider", choices=("densepose", "synthetic"), default="densepose")
    ap.add_argument("--flow", choices=("variational", "raft"), default="variational")
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    io = ArrayFrameIO()
    provider = (random_provider(dev) if args.provider == "densepose"
                else SyntheticIUVProvider())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)  # inside the checkout, ignored by git
    work = Path(tempfile.mkdtemp(prefix="profile_v2_", dir=BUILD_DIR))
    try:
        weights = (write_synthesized_checkpoint(work / "raft_large_synthesized.pth")
                   if args.flow == "raft" else None)
        fixture = work / "fixture"
        t0 = time.perf_counter()
        write_v2_fixture(fixture, io)
        fixture_s = time.perf_counter() - t0

        def run(name, timer=None):
            root = work / name
            shutil.copytree(fixture, root)
            t0 = time.perf_counter()
            run_v2_convert(chain_cfg(root), io, dev, provider, args.flow, timer, weights)
            torch.cuda.synchronize()
            return root, time.perf_counter() - t0

        _, cold_s = run("cold")
        timer = StageTimer(dev)
        for k in KERNELS:
            k.launches = 0
        root, timed_s = run("timed", timer)
        launches = {k.__name__: k.launches for k in KERNELS}
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            _, profiled_s = run("profiled")

        trainer = V2Trainer(v2_train_cfg(root, TRAIN_BATCH), io=io, device=dev)
        step_s, losses, peak = time_v2_train_steps(trainer, TRAIN_BATCH, TRAIN_STEPS)
        del trainer
    finally:
        shutil.rmtree(work, ignore_errors=True)

    required = ["component_extents"] + (["flow_level"] if args.flow == "variational" else [])
    if args.provider == "densepose":
        required.append("nms")
    check_launches(launches, required, "the v2 chain")
    summary = kernel_summary(prof, timed_s)
    videos = len(SETS)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "provider": args.provider,
        "flow": args.flow,
        "io": "ArrayFrameIO: lossless .npy payloads, no JPEG or AVI coding",
        "m_videos": videos,
        "frames_per_video": FRAMES,
        "hw": [240, 320],
        "fixture_s": round(fixture_s, 4),
        "convert_s": {"cold": round(cold_s, 4), "timed": round(timed_s, 4),
                      "profiled": round(profiled_s, 4)},
        "converter_s": {k: round(timer.seconds[k], 4) for k in CONVERTERS},
        "converter_s_per_video": {k: round(timer.seconds[k] / videos, 4) for k in CONVERTERS},
        "flow_pairs_per_s": round(videos * (FRAMES - 1) / timer.seconds["flow"], 3),
        "launches": launches,
        "launches_per_video": {k: v / videos for k, v in launches.items()},
        **summary,
        "v2_train": {"batch": TRAIN_BATCH, "steps": TRAIN_STEPS,
                     "ms_per_step": round(step_s * 1e3, 3),
                     "clips_per_s": round(TRAIN_BATCH / step_s, 3),
                     "peak_gib": round(peak / 2 ** 30, 3),
                     "loss_first_last": [round(losses[0], 4), round(losses[-1], 4)]},
    }, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
