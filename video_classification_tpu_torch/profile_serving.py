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
irls_coefficients, convolutions and matrix products, the rest), the launch counts, the top kernels, the kernel names in
each named group, and the device's busy share: profiled kernel time over
the unprofiled request time. Raises without CUDA, when a kernel of the
chosen path did not launch or a kernel of the other flow path did, and when
a port kernel is in no group of ``PORT_KERNELS``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType

from .config import load_model_cfg
from .engine import EnsemblePredictor, Predictor
from .pipeline.online import DensePoseOnlineDetector, flow_params_from_cfg
from .utils.cuda import resolve_device
from .utils.profiling import StageTimer
from .utils.synthetic import coherent_motion_frames

# The port's kernels are matched by their full names' prefix (they live in
# an anonymous namespace of csrc/*.cu; a template's name starts with its
# return type and goes on with its arguments, "void ...::name<8, 4>(...)"),
# the libraries' by substring. A kernel of that namespace that no group names is
# an error, not "other".
PORT_PREFIX = "(anonymous namespace)::"
PORT_KERNELS = (
    ("flow_level", ("maxflow_init_kernel", "warp_phi_kernel", "coeff_kernel",
                    "flow_level_sor_tile_kernel", "finish_kernel")),
    ("component_extents", ("extents_cluster_kernel", "extents_device_kernel")),
    ("nms", ("nms_sorted_kernel",)),
    ("sor_solve", ("sor_solve_setup_kernel", "sor_solve_tile_kernel")),
    ("warp_bilinear", ("warp_bilinear_kernel",)),
    ("label_components", ("labels_cluster_kernel", "labels_device_kernel")),
    ("irls_coefficients", ("irls_kernel",)),
)
# The groups each flow path must launch; the other path's must not launch.
FLOW_GROUPS = {"fused": ("flow_level",),
               "per-op": ("sor_solve", "warp_bilinear", "irls_coefficients")}
LIBRARY_KERNELS = ("conv_and_matmul", (
    "conv", "cudnn", "xmma", "gemm", "sm90", "implicit", "winograd", "fprop",
    "cutlass"))
GROUPS = tuple(g for g, _ in PORT_KERNELS) + (LIBRARY_KERNELS[0], "other")


def _group(name: str) -> str:
    for group, kernels in PORT_KERNELS:
        if any(name.startswith(f"{PORT_PREFIX}{k}(") or
               name.startswith(f"void {PORT_PREFIX}{k}<") for k in kernels):
            return group
    # A template of PyTorch's own anonymous namespaces also reads
    # "void (anonymous namespace)::...<...>": only plain names are checked.
    if name.startswith(PORT_PREFIX):
        raise RuntimeError(f"port kernel {name!r} is in no group of PORT_KERNELS")
    low = name.lower()
    if any(k in low for k in LIBRARY_KERNELS[1]):
        return LIBRARY_KERNELS[0]
    return "other"


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v:
            return float(v)
    return 0.0


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
    with torch.profiler.profile(activities=acts) as prof:
        pred.predict_frames(rgb, depth)
        torch.cuda.synchronize()
    # Device-side events only (kernels, copies): the CPU-side op entries
    # carry their kernels' time too and would count it twice.
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    groups = {g: {"ms": 0.0, "launches": 0} for g in GROUPS}
    for e in kernels:
        g = groups[_group(e.key)]
        g["ms"] += _device_us(e) / 1e3
        g["launches"] += int(e.count)
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
    device_ms = sum(g["ms"] for g in groups.values())
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
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
        "groups": {g: {"ms": round(v["ms"], 3), "launches": v["launches"]}
                   for g, v in groups.items()},
        "top_kernels": [{"name": e.key[:90], "ms": round(_device_us(e) / 1e3, 3),
                         "launches": int(e.count)} for e in top],
        "named_group_kernels": {
            g: sorted({e.key[:90] for e in kernels if _group(e.key) == g})
            for g in GROUPS[:-1]},
    }, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
