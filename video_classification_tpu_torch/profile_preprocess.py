"""Where the offline chain's time goes, on one NVIDIA GPU.

    python3 -m video_classification_tpu_torch.profile_preprocess
        [--provider {densepose,synthetic}]

Writes a raw fixture (``data/fixture.generate_raw_fixture``: one M_/K_ pair
of 130 240x320 frames per set, train and test, IsoGD's frame size and the
serving cells' video length) through ``ArrayFrameIO`` (lossless ``.npy``
payloads: the I/O stages' times exclude JPEG and AVI coding, so no codec
is needed), then runs the reference's chain (``pipeline/stages.FULL_CHAIN``:
sample, images, flow with the default parameters (K1), pad, IUV, crops
(K2)) three times, each on a fresh copy of the fixture: once cold, once
timed (seconds per stage, synchronised, and per M_ video), once under
``torch.profiler``. The
provider is the DensePose R-CNN at detectron2's test budget (depth 101,
ResizeShortestEdge 800/1333, 1000 per level, 1000, 100 detections, chart
pooler 28, ``chart_topk`` 1, batch 8, bfloat16) with seeded random weights,
its stem and box-delta layers scaled (``random_provider``; K3), or the
synthetic one. Prints one JSON object: stage seconds, launches of K1-K6 in
the timed run, device kernel ms by group (``profile_serving``'s groups),
the top kernels, and the busy share (profiled kernel time over the timed
run's seconds). Raises without CUDA, and when a kernel of the chain did not
launch or another did.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType

from .config import get_cfg
from .data.fixture import generate_raw_fixture
from .detect.nms import nms
from .detect.provider import DensePoseIUVProvider
from .ops.component_extents import component_extents
from .ops.flow_level import flow_level
from .ops.label_components import label_components
from .ops.sor_solve import sor_solve
from .ops.warp import warp_bilinear
from .pipeline import stages
from .pipeline.frame_io import ArrayFrameIO
from .pipeline.iuv_contract import SyntheticIUVProvider
from .profile_serving import GROUPS, _device_us, _group
from .utils.cuda import BUILD_DIR, resolve_device
from .utils.profiling import StageTimer

KERNELS = (flow_level, component_extents, nms, sor_solve, warp_bilinear, label_components)
SETS = ("train", "test")
FRAMES = 130


def random_provider(device, seed: int = 0, **budget) -> DensePoseIUVProvider:
    """The DensePose provider (depth 101 and detectron2's test budget unless
    ``budget`` says otherwise) with seeded random weights, two of them
    scaled so that random weights give boxes with area:
    the stem by 0.01 (pixel-scale frames then give the unit-scale
    activations of the CPU detector tests' frames; unscaled, every box
    collapses onto the frame's border) and the box-delta layers by 0.02, as
    those tests do (decoded boxes stay near their anchors)."""
    provider = DensePoseIUVProvider(allow_random_init=True, rng_seed=seed, device=device,
                                    **budget)
    model = provider.model
    with torch.no_grad():
        model.backbone.bottom_up.stem.conv1.weight.mul_(0.01)
        for layer in (model.proposal_generator["rpn_head"].anchor_deltas,
                      model.roi_heads["box_predictor"].bbox_pred):
            for p in layer.parameters():
                p.mul_(0.02)
    return provider


def chain_cfg(root):
    cfg = get_cfg()
    cfg.CHALEARN.ROOT = str(root)
    cfg.CHALEARN.SAMPLE_CLASS = 1
    return cfg


def write_fixture(root, io) -> None:
    """One class, one M_/K_ pair of FRAMES 240x320 frames per set."""
    generate_raw_fixture(chain_cfg(root), num_videos_per_set=1, num_classes=1,
                         num_frames=FRAMES, hw=(240, 320), sets=SETS, io=io)


def stage_files(root) -> dict:
    """File count of every stage folder under ``root``."""
    return {d.name: sum(1 for p in d.rglob("*") if p.is_file())
            for d in sorted(Path(root).iterdir()) if d.is_dir()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--provider", choices=("densepose", "synthetic"), default="densepose")
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    io = ArrayFrameIO()
    provider = (random_provider(dev) if args.provider == "densepose"
                else SyntheticIUVProvider())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)  # inside the checkout, ignored by git
    work = Path(tempfile.mkdtemp(prefix="profile_preprocess_", dir=BUILD_DIR))
    try:
        fixture = work / "fixture"
        t0 = time.perf_counter()
        write_fixture(fixture, io)
        fixture_s = time.perf_counter() - t0

        def run(name, timer=None):
            root = work / name
            shutil.copytree(fixture, root)
            t0 = time.perf_counter()
            stages.run_stages(chain_cfg(root), stages.FULL_CHAIN, provider,
                              SETS, io=io, device=dev, timer=timer)
            torch.cuda.synchronize()
            return root, time.perf_counter() - t0

        _, cold_s = run("cold")
        timer = StageTimer(dev)
        for k in KERNELS:
            k.launches = 0
        root, timed_s = run("timed", timer)
        launches = {k.__name__: k.launches for k in KERNELS}
        files = stage_files(root)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            _, profiled_s = run("profiled")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    required = ["flow_level", "component_extents"]
    if args.provider == "densepose":
        required.append("nms")
    for k in KERNELS:
        if (launches[k.__name__] > 0) != (k.__name__ in required):
            raise RuntimeError(f"{k.__name__}: {launches[k.__name__]} launches on the chain")
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    groups = {g: {"ms": 0.0, "launches": 0} for g in GROUPS}
    for e in kernels:
        g = groups[_group(e.key)]
        g["ms"] += _device_us(e) / 1e3
        g["launches"] += int(e.count)
    device_ms = sum(g["ms"] for g in groups.values())
    videos = len(SETS)
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "provider": args.provider,
        "io": "ArrayFrameIO: lossless .npy payloads, no JPEG or AVI coding",
        "m_videos": videos,
        "frames_per_video": FRAMES,
        "hw": [240, 320],
        "fixture_s": round(fixture_s, 4),
        "chain_s": {"cold": round(cold_s, 4), "timed": round(timed_s, 4),
                    "profiled": round(profiled_s, 4)},
        "stage_s": {k: round(v, 4) for k, v in timer.seconds.items()},
        "stage_s_per_video": {k: round(v / videos, 4) for k, v in timer.seconds.items()},
        "launches": launches,
        "launches_per_video": {k: v / videos for k, v in launches.items()},
        "files": files,
        "device_kernel_ms": round(device_ms, 3),
        "device_busy_share": (round(device_ms / 1e3 / timed_s, 4) if device_ms
                              else "not measured"),
        "groups": {g: {"ms": round(v["ms"], 3), "launches": v["launches"]}
                   for g, v in groups.items()},
        "top_kernels": [{"name": e.key[:90], "ms": round(_device_us(e) / 1e3, 3),
                         "launches": int(e.count)} for e in top],
    }, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
