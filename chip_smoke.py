#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (video_classification_tpu_torch) on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. environment: the card's name and power limit;
  2. build the three CUDA kernels from csrc/ (torch.utils.cpp_extension.load,
     sm_90a, into .torch_ext/);
  3. K1 flow_level against its plain PyTorch version at every pyramid level
     shape of a 240x320 frame: 4 coherent-motion pairs from a nonzero initial
     flow, then the serving batch (101 pairs, timed) from zero flow; each
     time uint8-encoded flow within +-1 on >= 99.9 % of values;
  4. K2 component_extents against its plain version, exactly, at 56x56 and
     112x112 on synthetic-detector charts, random masks, a serpentine longer
     than H + W, and the serving batch (20 part masks, timed);
  5. K3 nms against its plain version, exactly (indices and mask): the CPU
     test cases, N = 5000 with max_out 100, and the serving batches captured
     from the full-width detector's run on one clip's 20 padded frames,
     (20, 1264) at 0.7 / 64 and (20, 64) at 0.5 / 8 (timed);
  6. the serving path at full width with the synthetic detector:
     slowfast-HTAH (SlowFast-R50, 249 classes, 192 px crops, CLIP_LEN 20)
     with seeded random weights serves three 130-frame 240x320 synthetic
     videos (two clip windows each) through Predictor.predict_frames, with
     per-stage times per request; the launch counts are zeroed just before
     and read just after;
  7. the same with the DensePose detector at full width (depth 101, online
     budget 256 / 64 / 8, 112x112 charts, bfloat16, seeded random weights):
     K1, K2 and K3 launch counts, the detect stage, and the detections'
     sanity (boxes inside the padded frame, charts 0..24, U/V in [0, 1]);
  8. the synthetic-detector serving code at a small size on the card and on
     the CPU (plain versions), same frames and weights: clips within uint8
     +-1 on >= 99.9 %, scores within 5e-3;
  9. the DensePose-detector serving code at a small size (depth 50, pooler
     14, float32) on the card and on the CPU, same frames and weights:
     detections at the CPU tests' bars, then clips and scores as in 8.
Then one JSON line describing each kernel, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Exits non-zero without a result when CUDA is
unavailable.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 non-tensor FLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
FLOW_FRAC, FLOW_TOL = 0.999, 1
SCORE_ATOL = 5e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 3, warmup: int = 1) -> float:
    """Mean device time of fn() over reps, after warmup, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_call_ms(fn):
    """(fn(), its device time in ms by CUDA events), one call, no warm-up."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def within(a, b, tol: int) -> float:
    return float(((a.int() - b.int()).abs() <= tol).float().mean())


def flow_ops_per_pixel_outer(c: int, n_sor: int) -> int:
    """f32 operations of K1 per pixel per outer, counted from the kernel:
    warp + phi 40 + 7c, coefficients 35 + 34c, 34 per SOR sweep, finish 8."""
    return 83 + 41 * c + 34 * n_sor


def executed_outers(run, n_outer: int):
    """(B,) outers each pair ran in run(n_outer). A pair that stopped after k
    outers keeps its flow from then on, so its result equals run(k)'s; an
    outer that runs moves the flow by more than the tol, so no earlier one
    does. run(k) returns (u, v, mx) for n_outer = k."""
    import torch

    u, v, _ = run(n_outer)
    count = torch.full((u.shape[0],), n_outer, dtype=torch.int64, device=u.device)
    for k in range(n_outer - 1, 0, -1):
        uk, vk, _ = run(k)
        same = ((uk == u) & (vk == v)).flatten(1).all(1)
        count = torch.where(same, torch.full_like(count, k), count)
    return count


def check_flow_level(dev):
    import torch
    import torch.nn.functional as F

    from video_classification_tpu_torch.ops.flow import (
        FlowParams, _gaussian_blur, _pyramid_shapes, _resize_bilinear,
        encode_flow_uint8)
    from video_classification_tpu_torch.ops.flow_level import (
        flow_level, flow_level_reference)
    from video_classification_tpu_torch.utils.synthetic import coherent_motion_frames

    p = FlowParams()
    args = (p.n_sor, p.alpha, p.omega, p.eps, p.warp_radius, p.fuse_outer_tol)
    g = torch.Generator().manual_seed(1)
    frames = coherent_motion_frames(5, 240, 320, g).to(dev).float() / 255.0
    shapes = _pyramid_shapes(240, 320, p.ratio, p.min_width)
    sigma = (1.0 / p.ratio - 1.0) + 0.3
    pyr1, pyr2 = [frames[:-1].contiguous()], [frames[1:].contiguous()]
    for hw in shapes[1:]:
        pyr1.append(_resize_bilinear(_gaussian_blur(pyr1[-1], sigma), hw))
        pyr2.append(_resize_bilinear(_gaussian_blur(pyr2[-1], sigma), hw))

    worst = {"frac": 1.0, "err": 0.0}

    def compare(what, got, want):
        (uk, vk, mk), (ur, vr, mr) = got, want
        frac = within(encode_flow_uint8(uk, vk), encode_flow_uint8(ur, vr), FLOW_TOL)
        du, dv = float((uk - ur).abs().max()), float((vk - vr).abs().max())
        worst["frac"] = min(worst["frac"], frac)
        worst["err"] = max(worst["err"], du, dv)
        log(f"  K1 {what}: uint8 within +-1 {frac:.6f}, max|du| {du:.3e}, "
            f"max|dv| {dv:.3e}, max|dmx| {float((mk - mr).abs().max()):.3e}")
        if frac < FLOW_FRAC:
            raise AssertionError(f"K1 {what}: {frac} < {FLOW_FRAC}")

    for lvl, (h, w) in enumerate(shapes):
        noise = torch.randn((4, 2, 6, 8), generator=g)
        init = F.interpolate(noise, (h, w), mode="bilinear", align_corners=False) * 1.5
        u0, v0 = init[:, 0].contiguous().to(dev), init[:, 1].contiguous().to(dev)
        compare(f"{h}x{w} x4, nonzero start",
                flow_level(pyr1[lvl], pyr2[lvl], u0, v0, p.n_outer, *args),
                flow_level_reference(pyr1[lvl], pyr2[lvl], u0, v0, p.n_outer, *args))

    # The serving batch: one clip window's 101 frame pairs per call.
    b = 101
    rep = -(-b // 4)
    levels = []
    for lvl, (h, w) in enumerate(shapes):
        a1 = pyr1[lvl].repeat(rep, 1, 1, 1)[:b].contiguous()
        a2 = pyr2[lvl].repeat(rep, 1, 1, 1)[:b].contiguous()
        z = torch.zeros((b, h, w), device=dev)
        ms = cuda_ms(lambda: flow_level(a1, a2, z, z, p.n_outer, *args))
        got = flow_level(a1, a2, z, z, p.n_outer, *args)
        want, plain_ms = cuda_call_ms(
            lambda: flow_level_reference(a1, a2, z, z, p.n_outer, *args))
        compare(f"{h}x{w} x{b}, zero start", got, want)
        outers = int(executed_outers(
            lambda k: flow_level(a1, a2, z, z, k, *args), p.n_outer).sum())
        ops = outers * h * w * flow_ops_per_pixel_outer(3, p.n_sor)
        nbytes = (2 * a1.numel() + 4 * z.numel() + b) * 4
        bound = 1e3 * max(ops / PEAK_F32_OPS_PER_S, nbytes / PEAK_BYTES_PER_S)
        row = {"level": f"{h}x{w}", "pairs": b, "ms": round(ms, 4),
               "outers": outers, "bound_ms": round(bound, 4),
               "bound_by": "operations" if ops / PEAK_F32_OPS_PER_S
               > nbytes / PEAK_BYTES_PER_S else "bytes",
               "plain_ms": round(plain_ms, 4)}
        levels.append(row)
        log(f"  K1 time {json.dumps(row)}")
    return {"max_abs_err": worst["err"], "worst_within": worst["frac"],
            "levels": levels, **levels[0]}


def serpentine(h: int, w: int):
    import torch

    m = torch.zeros((h, w), dtype=torch.bool)
    m[0::2] = True
    for i, r in enumerate(range(1, h, 2)):
        m[r, w - 1 if i % 2 == 0 else 0] = True
    return m


def check_component_extents(dev):
    import torch

    from video_classification_tpu_torch.config.crop_cfg import crop_part_args
    from video_classification_tpu_torch.ops.component_extents import (
        component_extents, component_extents_reference)
    from video_classification_tpu_torch.ops.components import part_mask
    from video_classification_tpu_torch.pipeline.online import SyntheticOnlineDetector

    def exact(what, masks):
        """Max |kernel - plain| over the four fields; fails unless 0."""
        err = max(int((a.long() - b.long()).abs().max()) for a, b in
                  zip(component_extents(masks), component_extents_reference(masks)))
        if err != 0:
            raise AssertionError(f"K2 {what}: max |kernel - plain| {err}")
        log(f"  K2 {what}: exact")
        return err

    g = torch.Generator().manual_seed(2)
    max_err = 0
    for hm in (56, 112):
        charts = torch.from_numpy(SyntheticOnlineDetector(hm)._charts())
        chart_masks = torch.stack([part_mask(charts, ids) for ids, _ in crop_part_args])
        cases = {
            "charts": chart_masks,
            "random0.45": torch.rand((32, hm, hm), generator=g) < 0.45,
            "random0.25": torch.rand((32, hm, hm), generator=g) < 0.25,
            "serpentine": serpentine(hm, hm)[None],
        }
        for name, masks in cases.items():
            max_err = max(max_err, exact(f"{hm}x{hm} {name} x{masks.shape[0]}",
                                         masks.to(dev)))

    # The serving shape: one clip's 20 sampled frames, CropHTAH part mask, at
    # the synthetic detector's 56x56 heatmap (and DensePose's 112x112).
    rows = []
    for hm in (56, 112):
        charts = torch.from_numpy(SyntheticOnlineDetector(hm)._charts())
        masks = part_mask(charts, crop_part_args[0][0]).expand(20, hm, hm).contiguous().to(dev)
        max_err = max(max_err, exact(f"{hm}x{hm} serving masks x20", masks))
        ms = cuda_ms(lambda: component_extents(masks), reps=20)
        want, plain = cuda_call_ms(lambda: component_extents_reference(masks))
        lo, hi = 0, 2 * hm
        while lo < hi:  # fewest iterations that reach the fixed point
            mid = (lo + hi) // 2
            if all(torch.equal(a, b) for a, b in
                   zip(component_extents_reference(masks, mid), want)):
                hi = mid
            else:
                lo = mid + 1
        iters = min(lo + 1, 2 * hm)  # the last iteration sees no change
        b, h, w = masks.shape
        ops = b * iters * h * w * (8 * 4 + 4)
        nbytes = b * h * w * (1 + 16)
        row = {"masks": f"20x{hm}x{hm}", "ms": round(ms, 4),
               "plain_ms": round(plain, 4), "iters": iters,
               "bound_ms": 1e3 * max(ops / PEAK_F32_OPS_PER_S, nbytes / PEAK_BYTES_PER_S),
               "bound_by": "operations" if ops / PEAK_F32_OPS_PER_S
               > nbytes / PEAK_BYTES_PER_S else "bytes"}
        log(f"  K2 time {json.dumps(row)}")
        rows.append(row)
    # The DensePose path's shape (the synthetic path's 56x56 row is logged).
    return {**rows[-1], "max_abs_err": max_err}


def nms_boxes(n: int, seed: int, extent: float):
    """n random xyxy boxes and scores from a numpy seed (the CPU tests')."""
    import numpy as np

    rng = np.random.RandomState(seed)
    centers = rng.rand(n, 2) * extent
    sizes = 4 + rng.rand(n, 2) * extent / 3
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], 1)
    return boxes.astype(np.float32), rng.rand(n).astype(np.float32)


# f32 operations of K3 per box per executed iteration, counted from the
# kernel: IoU 13 (min, max, sub, max per axis; mul; add, sub, max; div),
# suppress test 2, running argmax 2.
NMS_OPS_PER_BOX_ITER = 17


def capture_nms_batches(detector, frames):
    """(boxes, scores, max_out, thr) of every nms call of one detector run
    on ``frames``, and the detections."""
    import video_classification_tpu_torch.detect.densepose as dp

    real, calls = dp.nms, []

    def record(boxes, scores, max_out, thr):
        calls.append((boxes.clone(), scores.clone(), max_out, thr))
        return real(boxes, scores, max_out, thr)

    dp.nms = record
    try:
        dets = detector(frames)
    finally:
        dp.nms = real
    return calls, dets


def check_nms(dev, serving_calls):
    import numpy as np
    import torch

    from video_classification_tpu_torch.detect.nms import NEG, nms, nms_reference

    def exact(what, boxes, scores, max_out, thr):
        """Max |kernel - plain| over indices, plus mask mismatches; fails
        unless 0."""
        (ki, km), (ri, rm) = nms(boxes, scores, max_out, thr), nms_reference(
            boxes, scores, max_out, thr)
        err = int((ki.long() - ri.long()).abs().max()) + int((km != rm).sum())
        if err != 0 or ki.dtype != torch.int32 or km.dtype != torch.bool:
            raise AssertionError(f"K3 {what}: kernel and plain differ ({err})")
        return err, km

    def case(what, boxes, scores, max_out, thr):
        b = torch.as_tensor(boxes, device=dev)
        sc = torch.as_tensor(scores, device=dev)
        if b.dim() == 2:
            b, sc = b[None], sc[None]
        err, mask = exact(what, b, sc, max_out, thr)
        log(f"  K3 {what}: exact, {int(mask.sum())} kept")
        return err

    err = 0
    for n in (20, 64, 1264):
        boxes, scores = nms_boxes(n, n, 60.0 if n < 1000 else 400.0)
        for max_out in (8, 64, n + 3):
            for thr in (0.5, 0.7):
                err = max(err, case(f"N {n} max_out {max_out} thr {thr}",
                                    boxes, scores, max_out, thr))
    boxes, _ = nms_boxes(64, 1, 60.0)
    err = max(err, case("equal scores", boxes, np.full((64,), 0.5, np.float32), 20, 0.5))
    b16, s16 = nms_boxes(16, 2, 60.0)
    err = max(err, case("duplicate boxes", np.concatenate([b16, b16, b16[:4]]),
                        np.concatenate([s16, s16[::-1], s16[:4]]), 24, 0.5))
    err = max(err, case("all at the sentinel", nms_boxes(20, 3, 60.0)[0],
                        np.full((20,), NEG, np.float32), 8, 0.5))
    frames = [nms_boxes(64, 10 + i, 60.0) for i in range(3)]
    fb, fs = np.stack([b for b, _ in frames]), np.stack([s for _, s in frames])
    fs[1] = NEG
    err = max(err, case("batch of 3 with an empty frame", fb, fs, 12, 0.5))
    boxes, scores = nms_boxes(5000, 4, 800.0)
    err = max(err, case("N 5000 max_out 100 (provider budget)", boxes, scores, 100, 0.7))

    rows = []
    for boxes, scores, max_out, thr in serving_calls:
        bsz, n = scores.shape
        what = f"serving {bsz}x{n} thr {thr} max_out {max_out}"
        err = max(err, exact(what, boxes, scores, max_out, thr)[0])
        ms = cuda_ms(lambda: nms(boxes, scores, max_out, thr), reps=20)
        (_, mask), plain = cuda_call_ms(lambda: nms_reference(boxes, scores, max_out, thr))
        # The loop ends after the first empty slot: count the iterations
        # this data needs. The real limit is latency, max_out dependent
        # block-wide reductions per frame; the bound below counts only
        # operations and bytes.
        iters = int(torch.clamp(mask.sum(1) + 1, max=max_out).sum())
        ops = iters * n * NMS_OPS_PER_BOX_ITER + bsz * n * 4
        nbytes = bsz * n * 20 + bsz * max_out * 5
        row = {"batch": f"{bsz}x{n}", "thr": thr, "max_out": max_out,
               "kept": int(mask.sum()), "iters": iters, "ms": round(ms, 4),
               "plain_ms": round(plain, 4),
               "bound_ms": 1e3 * max(ops / PEAK_F32_OPS_PER_S, nbytes / PEAK_BYTES_PER_S),
               "bound_by": "operations" if ops / PEAK_F32_OPS_PER_S
               > nbytes / PEAK_BYTES_PER_S else "bytes"}
        log(f"  K3 {what}: exact; time {json.dumps(row)}")
        rows.append(row)
    if {r["batch"] for r in rows} != {"20x1264", "20x64"}:
        raise AssertionError(f"K3: serving batches {[r['batch'] for r in rows]}")
    return {**rows[0], "rows": rows, "max_abs_err": err}


def synthetic_videos(n: int = 3):
    """n 130-frame 240x320 coherent-motion videos (rgb, depth) as numpy."""
    import torch

    from video_classification_tpu_torch.utils.synthetic import coherent_motion_frames

    videos = []
    for r in range(n):
        rgb = coherent_motion_frames(130, 240, 320, torch.Generator().manual_seed(10 + r))
        depth = rgb.float().mean(-1, keepdim=True).to(torch.uint8)
        videos.append((rgb.numpy(), depth.numpy()))
    return videos


def htah_cfg(root: str):
    from video_classification_tpu_torch.config import load_model_cfg

    return load_model_cfg("slowfast-HTAH", ["CHALEARN.ROOT", root])


def full_width_detector(dev, root: str):
    """The online DensePose detector at full width: depth 101, the online
    budget (pre 256, post 64, 8 detections, pooler 28), one chunk per clip's
    CLIP_LEN frames, bfloat16 on the card, seeded random weights."""
    from video_classification_tpu_torch.pipeline.online import DensePoseOnlineDetector

    cfg = htah_cfg(root)
    return DensePoseOnlineDetector(cfg, depth=101, batch_size=int(cfg.CHALEARN.CLIP_LEN),
                                   allow_random_init=True, device=dev)


def serve_full_width(dev, root: str, videos, kernels, detector=None):
    """Three requests through Predictor.predict_frames; ``kernels`` are the
    wrappers whose launch counts are zeroed just before and read just
    after. Returns (counts, latencies, the detections the detector gave)."""
    import numpy as np

    from video_classification_tpu_torch.engine import Predictor
    from video_classification_tpu_torch.utils.profiling import StageTimer

    cfg = htah_cfg(root)
    timer = StageTimer(dev)
    seen = []

    def recording(frames):
        dets = detector(frames)
        seen.append(dets)
        return dets

    t0 = time.perf_counter()
    pred = Predictor(cfg, device=dev, timer=timer,
                     detector=None if detector is None else recording)
    log(f"  model: depth {cfg.MODEL.DEPTH}, {cfg.CHALEARN.NUM_CLASS} classes, "
        f"{pred.mm.crop_size} px, CLIP_LEN {cfg.CHALEARN.CLIP_LEN}, "
        f"{cfg.CUDA.COMPUTE_DTYPE}; built in {time.perf_counter() - t0:.2f} s")

    for k in kernels:
        k.launches = 0
    timer.seconds.clear()
    latencies = []
    for r, (rgb, depth) in enumerate(videos):
        t0 = time.perf_counter()
        y = pred.predict_frames(rgb, depth, top_k=5)
        latencies.append(time.perf_counter() - t0)
        probs = y["probs"]
        if probs.shape != (249,) or not np.isfinite(probs).all():
            raise AssertionError(f"request {r}: bad probabilities {probs.shape}")
        if abs(float(probs.sum()) - 1.0) > 1e-4:
            raise AssertionError(f"request {r}: probabilities sum to {probs.sum()}")
        if y["clips"] != 2:
            raise AssertionError(f"request {r}: {y['clips']} clip windows, expected 2")
        log(f"  request {r}: {y['clips']} clips, {latencies[-1]:.3f} s, top-5 "
            + ", ".join(f"{c}:{p:.4f}" for c, p in y["top"]))
        log(f"    stage seconds: {json.dumps({k: round(v, 4) for k, v in timer.seconds.items()})}")
        timer.seconds.clear()
    counts = {k.__name__: k.launches for k in kernels}
    log(f"  launches on the serving path: {json.dumps(counts)}")
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"serving path never launched {name}")
    return counts, latencies, seen


def check_detections(dets, padded_hw):
    """Boxes inside the padded frame, charts 0..24, U/V in [0, 1], finite."""
    import torch

    ph, pw = padded_hw
    for d in dets:
        b = d.boxes_xyxy
        ok = (bool(torch.isfinite(b).all()) and float(b[:, 0].min()) >= 0
              and float(b[:, 1].min()) >= 0 and float(b[:, 2].max()) <= pw
              and float(b[:, 3].max()) <= ph
              and bool((b[:, 2] >= b[:, 0]).all() and (b[:, 3] >= b[:, 1]).all())
              and int(d.charts.min()) >= 0 and int(d.charts.max()) <= 24
              and float(d.uv.min()) >= 0.0 and float(d.uv.max()) <= 1.0)
        if not ok:
            raise AssertionError("detections out of range")
    frames = sum(d.valid.shape[0] for d in dets)
    valid = sum(int(d.valid.sum()) for d in dets)
    labels = sorted(set().union(*(set(d.charts.unique().tolist()) for d in dets)))
    log(f"  detections: {frames} frames, {valid} valid, "
        f"{dets[0].charts.shape[-1]}x{dets[0].charts.shape[-1]} charts, labels {labels}")


def serve_small_against_cpu(dev, root: str):
    import torch

    from video_classification_tpu_torch.config import load_model_cfg
    from video_classification_tpu_torch.engine import Predictor
    from video_classification_tpu_torch.utils.synthetic import coherent_motion_frames

    cfg = load_model_cfg("slowfast-LHand", [
        "CHALEARN.ROOT", root, "MODEL.DEPTH", "18", "CHALEARN.CLIP_LEN", "2",
        "CHALEARN.NUM_CLASS", "5", "CUDA.COMPUTE_DTYPE", "float32"])
    rgb = coherent_motion_frames(34, 64, 96, torch.Generator().manual_seed(3)).numpy()
    gpu = Predictor(cfg, device=dev)
    cpu = Predictor(cfg, device="cpu", state_dict=gpu.model.state_dict())
    clips = []
    for p in (gpu, cpu):
        clips.append(torch.stack(p.dataset(videos={0: (rgb, None)})
                                 .get_eval_clips(0, random.Random(0))["clips"]).cpu())
    frac = within(clips[0], clips[1], 1)
    sg, sc = gpu.clip_scores_frames(rgb), cpu.clip_scores_frames(rgb)
    err = float(abs(sg - sc).max())
    log(f"  small serve card vs cpu: {clips[0].shape[0]} clips, uint8 within +-1 "
        f"{frac:.6f}, max|dscore| {err:.3e}")
    if frac < FLOW_FRAC or err > SCORE_ATOL:
        raise AssertionError(f"card and cpu disagree: {frac}, {err}")


def serve_small_detector_against_cpu(dev, root: str):
    """The DensePose-detector serving code at depth 50, pooler 14, float32,
    on the card and on the CPU with the same weights and frames."""
    import numpy as np
    import torch

    from video_classification_tpu_torch.config import load_model_cfg
    from video_classification_tpu_torch.engine import Predictor
    from video_classification_tpu_torch.pipeline.online import DensePoseOnlineDetector
    from video_classification_tpu_torch.utils.synthetic import coherent_motion_frames

    cfg = load_model_cfg("slowfast-LHand", [
        "CHALEARN.ROOT", root, "MODEL.DEPTH", "18", "CHALEARN.CLIP_LEN", "2",
        "CHALEARN.NUM_CLASS", "5", "CUDA.COMPUTE_DTYPE", "float32"])
    kw = dict(depth=50, chart_pooler_size=14, batch_size=2, compute_dtype="float32")
    gpu_det = DensePoseOnlineDetector(cfg, allow_random_init=True, device=dev, **kw)
    cpu_det = DensePoseOnlineDetector(
        cfg, state_dict={k: v.cpu() for k, v in gpu_det.model.state_dict().items()},
        device="cpu", **kw)
    rgb = coherent_motion_frames(34, 64, 96, torch.Generator().manual_seed(3)).numpy()
    gpu = Predictor(cfg, device=dev, detector=gpu_det)
    cpu = Predictor(cfg, device="cpu", detector=cpu_det, state_dict=gpu.model.state_dict())
    clips, caches = [], []
    for p in (gpu, cpu):
        ds = p.dataset(videos={0: (rgb, None)})
        clips.append(torch.stack(ds.get_eval_clips(0, random.Random(0))["clips"]).cpu())
        caches.append(ds._det_cache[0])
    worst = {"box": 0.0, "chart": 1.0, "uv": 0.0}
    for r in sorted(caches[1]):
        (gb, gv, gc, guv), (cb, cv, cc, cuv) = ([t.cpu() for t in c[r]] for c in caches)
        same = gc == cc
        worst["box"] = max(worst["box"], float((gb - cb).abs().max()))
        worst["chart"] = min(worst["chart"], float(same.float().mean()))
        worst["uv"] = max(worst["uv"], float((guv - cuv).abs()[:, same].max()))
        if bool(gv) != bool(cv):
            raise AssertionError(f"frame {r}: valid {bool(gv)} vs {bool(cv)}")
    frac = within(clips[0], clips[1], 1)
    sg, sc = gpu.clip_scores_frames(rgb), cpu.clip_scores_frames(rgb)
    err = float(np.abs(sg - sc).max())
    log(f"  small detector serve card vs cpu: {len(caches[1])} frames, max|dbox| "
        f"{worst['box']:.3e} px, charts equal {worst['chart']:.6f}, max|duv| "
        f"{worst['uv']:.3e}; {clips[0].shape[0]} clips, uint8 within +-1 "
        f"{frac:.6f}, max|dscore| {err:.3e}")
    if (worst["box"] > 1e-3 or worst["chart"] < 0.999 or worst["uv"] > 1e-3
            or frac < FLOW_FRAC or err > SCORE_ATOL):
        raise AssertionError(f"card and cpu disagree: {worst}, {frac}, {err}")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from pathlib import Path

    from video_classification_tpu_torch.utils.cuda import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    # A checkpoint root with no checkpoints: the models keep seeded random weights.
    root = str(Path(__file__).resolve().parent / ".torch_ext" / "no_checkpoints")
    t_start = time.perf_counter()
    smi = nvidia_smi()
    log(f"[1] device {torch.cuda.get_device_name(0)} ({smi}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    build()
    log(f"[2] built the three kernels (torch.utils.cpp_extension.load) in "
        f"{time.perf_counter() - t0:.2f} s")

    from video_classification_tpu_torch.detect.nms import nms
    from video_classification_tpu_torch.ops.component_extents import component_extents
    from video_classification_tpu_torch.ops.flow_level import flow_level

    log("[3] K1 flow_level vs plain")
    k1 = check_flow_level(dev)
    log("[4] K2 component_extents vs plain")
    k2 = check_component_extents(dev)

    log("[5] K3 nms vs plain")
    videos = synthetic_videos()
    t0 = time.perf_counter()
    detector = full_width_detector(dev, root)
    log(f"  detector: depth 101, heatmap {detector.heatmap_size}, "
        f"{detector.model.compute_dtype}; built in {time.perf_counter() - t0:.2f} s")
    # The first clip window's 20 sampled frames, 2x padded as the dataset does.
    rgb = torch.from_numpy(np.ascontiguousarray(videos[0][0][::5][:20])).to(dev)
    padded = rgb.new_zeros((20, 480, 640, 3))
    padded[:, 120:360, 160:480] = rgb
    calls, dets = capture_nms_batches(detector, padded)
    check_detections([dets], (480, 640))
    k3 = check_nms(dev, calls)

    log("[6] serving slowfast-HTAH at full width, synthetic detector")
    synth_counts, synth_lat, _ = serve_full_width(
        dev, root, videos, (flow_level, component_extents))
    log("[7] serving slowfast-HTAH at full width, DensePose detector")
    counts, latencies, seen = serve_full_width(
        dev, root, videos, (flow_level, component_extents, nms), detector=detector)
    check_detections(seen, (480, 640))
    log("[8] small serve: card vs cpu")
    serve_small_against_cpu(dev, root)
    log("[9] small DensePose-detector serve: card vs cpu")
    serve_small_detector_against_cpu(dev, root)

    kernels = [
        {"name": "flow_level", "route": "cuda",
         "source": "video_classification_tpu_torch/csrc/flow_level.cu",
         "replaces": "video_classification_tpu/ops/pallas_flow.py:320",
         "launches": counts["flow_level"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": None},
        {"name": "component_extents", "route": "cuda",
         "source": "video_classification_tpu_torch/csrc/component_extents.cu",
         "replaces": "video_classification_tpu/ops/pallas_components.py:70",
         "launches": counts["component_extents"], "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": None},
        {"name": "nms", "route": "cuda",
         "source": "video_classification_tpu_torch/csrc/nms.cu",
         "replaces": "video_classification_tpu/detect/pallas_nms.py:28",
         "launches": counts["nms"], "max_abs_err": k3["max_abs_err"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": None},
    ]
    log(f"done in {time.perf_counter() - t_start:.1f} s; K2 iterations "
        f"{k2['iters']}; synthetic-detector launches {json.dumps(synth_counts)}, "
        f"request seconds {[round(x, 3) for x in synth_lat]}; DensePose-detector "
        f"request seconds {[round(x, 3) for x in latencies]}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
