"""Where a serving request's device time goes, on one NVIDIA GPU.

    python3 -m video_classification_tpu_torch.profile_serving [--requests 3]
        [--detector {synthetic,densepose}] [--flow {fused,per-op}] [--ensemble]

Serves 130-frame 240x320 synthetic videos (two clip windows each) through
the slowfast-HTAH Predictor at full width with seeded random weights, or
with ``--ensemble`` through the EnsemblePredictor of the five part streams
(engine/sparse.PART_YAMLS, each at its published crop; no fusion checkpoint,
so uniform mixing), with
the synthetic detector or the DensePose detector (depth 101, the online
budget, bfloat16, seeded random weights), and the fused flow level (K1) or
the per-op one (``FlowParams(fuse_level="off")``: per outer the K5 warp,
and per inner the IRLS coefficients' kernel and the K4 solve): one warm-up
request, then
``--requests`` timed ones (host clock, synchronised), then one request under
``torch.profiler``. Prints the mean stage seconds of the timed requests
(detect, flow, crops, network: synchronised at each stage's ends, in
requests of their own; per stream with ``--ensemble``), the kernel time
summed by
group (K1 flow_level, K2 component_extents, K3 nms, K4 sor_solve, K5
warp_bilinear, K6 label_components, the IRLS coefficients
irls_coefficients, convolutions and matrix products, the rest), the launch
counts, the top kernels, the kernel names in each named group, the
program's counts of the profiled request (``utils/profiling.COUNTS``: the
frame pairs the flow solved, and its levels whose SOR ran resident or
tiled), and the device's busy share: profiled kernel time over the
unprofiled request time.
A port kernel's group is the ``kernel::<wrapper>`` span (utils/profiling
.span) that its wrapper opens around the launch; a device operation under no
such span is grouped by its name. Raises without CUDA, and when a kernel of
the chosen path did not launch or a kernel of the other flow path did.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable

import torch
from torch.autograd import DeviceType

from .config import load_model_cfg
from .detect.nms import nms
from .engine import EnsemblePredictor, Predictor
from .ops.component_extents import component_extents
from .ops.flow_level import flow_level
from .ops.irls import irls_coefficients
from .ops.label_components import label_components
from .ops.sor_solve import sor_solve
from .ops.warp import warp_bilinear
from .pipeline.online import DensePoseOnlineDetector, flow_params_from_cfg
from .utils.cuda import resolve_device
from .utils import profiling
from .utils.profiling import StageTimer
from .utils.synthetic import coherent_motion_frames

# The port's kernels, by the wrappers that launch them: each opens the span
# "kernel::<its name>" around its launch.
WRAPPERS = (flow_level, component_extents, nms, sor_solve, warp_bilinear,
            label_components, irls_coefficients)
KERNEL_SPAN = "kernel::"
# The groups each flow path must launch; the other path's must not launch.
FLOW_GROUPS = {"fused": ("flow_level",),
               "per-op": ("sor_solve", "warp_bilinear", "irls_coefficients")}
LIBRARY_KERNELS = ("conv_and_matmul", (
    "conv", "cudnn", "xmma", "gemm", "sm90", "implicit", "winograd", "fprop",
    "cutlass"))
GROUPS = tuple(k.__name__ for k in WRAPPERS) + (LIBRARY_KERNELS[0], "other")


def group_of(kernel: str, scopes: Iterable[str]) -> str:
    """The group of a device operation named ``kernel`` whose launch ran
    inside the host ranges ``scopes``: the wrapper of the ``kernel::`` span
    among them, else the libraries' group by the name, else 'other'."""
    for scope in scopes:
        if scope.startswith(KERNEL_SPAN):
            return scope[len(KERNEL_SPAN):]
    low = kernel.lower()
    if any(k in low for k in LIBRARY_KERNELS[1]):
        return LIBRARY_KERNELS[0]
    return "other"


def device_time(prof) -> Dict[str, Dict]:
    """Each device operation of a ``torch.profiler`` session under the host
    call that launched it: {'groups': {group: {'ms', 'launches'}},
    'kernels': {name: {'ms', 'launches', 'group'}}}. An operation and its
    launch (a call of the CUDA runtime or driver, named "cu...") share a
    correlation id, and the launch's enclosing host ranges are its scopes:
    the port's extension launches under no aten op, only under its
    wrapper's span. A ``record_function`` range also shows on the device
    timeline, as an annotation named like its host event: those are not
    operations."""
    events = prof.events()
    host = [e for e in events if e.device_type == DeviceType.CPU]
    names = {e.name for e in host}
    launches = {e.id: e for e in host if e.name.startswith("cu") and "::" not in e.name}
    groups = {g: {"ms": 0.0, "launches": 0} for g in GROUPS}
    kernels: Dict[str, Dict] = defaultdict(lambda: {"ms": 0.0, "launches": 0})
    for d in events:
        if d.device_type != DeviceType.CUDA or d.name in names:
            continue
        scopes, scope = [], launches.get(d.id)
        while scope is not None:
            scopes.append(scope.name)
            scope = scope.cpu_parent
        group = group_of(d.name, scopes)
        for row in (groups[group], kernels[d.name]):
            row["ms"] += (d.time_range.end - d.time_range.start) / 1e3
            row["launches"] += 1
        kernels[d.name]["group"] = group
    return {"groups": groups, "kernels": dict(kernels)}


def summary(prof, top: int = 12) -> Dict:
    """``device_time`` rounded for printing: the groups, the ``top``
    kernels, the kernel names in each named group, the device ms in all."""
    t = device_time(prof)
    ranked = sorted(t["kernels"].items(), key=lambda kv: -kv[1]["ms"])
    return {
        "device_kernel_ms": sum(g["ms"] for g in t["groups"].values()),
        "groups": {g: {"ms": round(v["ms"], 3), "launches": v["launches"]}
                   for g, v in t["groups"].items()},
        "top_kernels": [{"name": n[:90], "ms": round(v["ms"], 3), "launches": v["launches"]}
                        for n, v in ranked[:top]],
        "named_group_kernels": {
            g: sorted({n[:90] for n, v in ranked if v["group"] == g}) for g in GROUPS[:-1]},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--detector", choices=("synthetic", "densepose"),
                    default="synthetic")
    ap.add_argument("--flow", choices=tuple(FLOW_GROUPS), default="fused")
    ap.add_argument("--ensemble", action="store_true",
                    help="the five part streams fused (EnsemblePredictor)")
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    # A root without checkpoints: the model keeps its seeded random weights.
    root = str(Path(__file__).resolve().parent / "no_checkpoints")
    cfg = load_model_cfg("slowfast-HTAH", ["CHALEARN.ROOT", root])
    detector = None
    if args.detector == "densepose":
        detector = DensePoseOnlineDetector(
            cfg, depth=101, batch_size=int(cfg.CHALEARN.CLIP_LEN),
            allow_random_init=True, device=dev)
    flow_params = None
    if args.flow == "per-op":
        flow_params = flow_params_from_cfg(cfg)._replace(fuse_level="off")
    if args.ensemble:
        pred = EnsemblePredictor(cfg_overrides=["CHALEARN.ROOT", root], detector=detector,
                                 flow_params=flow_params, device=dev)
        streams = dict(zip(pred.part_yamls, pred.predictors))
    else:
        pred = Predictor(cfg, device=dev, detector=detector, flow_params=flow_params)
        streams = {cfg.MODEL.NAME: pred}
    rgb = coherent_motion_frames(130, 240, 320, torch.Generator().manual_seed(10))
    depth = rgb.float().mean(-1, keepdim=True).to(torch.uint8)
    rgb, depth = rgb.numpy(), depth.numpy()

    pred.predict_frames(rgb, depth)  # warm-up: cuDNN plans, allocator
    walls = []
    for _ in range(args.requests):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.predict_frames(rgb, depth)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = sum(walls) / len(walls)
    # Stage times from as many further requests, timed separately: the
    # timer's syncs would lengthen the requests timed above.
    for p in streams.values():
        p.timer = StageTimer(dev)
    for _ in range(args.requests):
        pred.predict_frames(rgb, depth)
    stages = {name: {k: round(v / args.requests, 4) for k, v in p.timer.seconds.items()}
              for name, p in streams.items()}
    for p in streams.values():
        p.timer = None

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    before = profiling.COUNTS.copy()
    with torch.profiler.profile(activities=acts) as prof:
        pred.predict_frames(rgb, depth)
        torch.cuda.synchronize()
    counts = dict(profiling.COUNTS - before)
    kernels = summary(prof)
    groups = kernels["groups"]
    required = FLOW_GROUPS[args.flow] + ("component_extents",)
    if detector is not None:
        required += ("nms",)
    for group in required:
        if groups[group]["launches"] == 0:
            raise RuntimeError(f"no {group} kernel in the profile")
    other = next(f for f in FLOW_GROUPS if f != args.flow)
    for group in FLOW_GROUPS[other]:
        if groups[group]["launches"]:
            raise RuntimeError(f"{group} launched on the {args.flow} flow path")
    device_ms = kernels.pop("device_kernel_ms")
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "detector": args.detector,
        "flow": args.flow,
        "streams": list(streams),
        "stage_mean_s": stages if args.ensemble else next(iter(stages.values())),
        "request_s": [round(w, 4) for w in walls],
        "request_mean_s": round(wall, 4),
        "device_kernel_ms": round(device_ms, 3),
        "device_busy_share": (round(device_ms / 1e3 / wall, 4) if device_ms
                              else "not measured"),
        "counts": counts,
        **kernels,
    }, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
