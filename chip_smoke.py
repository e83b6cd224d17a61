#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (video_classification_tpu_torch) on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. environment: the card's name and power limit;
  2. build the CUDA kernels of utils/cuda.SOURCES from csrc/, with the
     headers of utils/cuda.HEADERS (the SOR tiles, sor_tiles.cuh, and the
     cluster strips, cluster_strips.cuh)
     (torch.utils.cpp_extension.load, sm_90a, into .torch_ext/);
  3. K1 flow_level bit-equal to its plain PyTorch version (u, v and mx) at
     every pyramid level shape of a 240x320 frame: 4 coherent-motion pairs
     from a nonzero initial flow, then the serving batch (101 pairs, timed)
     from zero flow; and on random pairs at the SOR tiles' edge shapes and
     sweep counts (EDGE_SHAPES x edge_sweeps()); each level's half-sweeps per
     launch and device time per half-sweep;
  4. K2 component_extents against its plain version, exactly, at 56x56 and
     112x112 on synthetic-detector charts, random masks, a serpentine longer
     than H + W; on the strip-boundary shapes (1xW, Hx1 up to 255, 13x17,
     57x76, 112x112, 255x255 in narrow words; 1x256, 256x1, 257x300 and
     240x320 in wide words on the cluster; 300x320, 4x330 and 480x640 in
     device memory) with random, sparse, empty, chart and horizontal and
     vertical serpentine masks at the iteration caps around the iterations
     per halo exchange and at H + W; then timed, with each mask's executed
     iterations and the time per dependent iteration: the synthetic charts
     at 56x56 and 112x112, the six part masks of the DensePose detector's
     first chart nearest-resized to 240x320 and 480x640 (wide words), and
     the CropHTAH masks of the detector's own 112x112 charts from one
     full-width detector run on one clip's 20 padded frames (the serving
     batch, the kernel's row);
  5. K3 nms against its plain version, exactly (indices and mask): the CPU
     test cases, N on both sides of one and two 64-candidate chunks, max_out
     reached inside a chunk, a chunk the kept boxes suppress entirely, ties
     with +-0.0, -inf and NEG, N = 5000 and 8192, and the serving batches
     captured from the same detector run, (20, 1264) at 0.7 / 64 and
     (20, 64) at 0.5 / 8 (timed);
  6. the serving path at full width with the synthetic detector:
     slowfast-HTAH (SlowFast-R50, 249 classes, 192 px crops, CLIP_LEN 20)
     with seeded random weights serves three 130-frame 240x320 synthetic
     videos (two clip windows each) through Predictor.predict_frames, with
     per-stage times per request; the launch counts are zeroed just before
     and read just after (K1 and K2 must launch, K4-K6 must not);
  7. the same with the DensePose detector at full width (depth 101, online
     budget 256 / 64 / 8, 112x112 charts, bfloat16, seeded random weights):
     K1, K2 and K3 launch counts, the detect stage, and the detections'
     sanity (boxes inside the padded frame, charts 0..24, U/V in [0, 1]);
     K3 on the box head's captured call (20 x 64 boxes, 8 slots) alone on
     the device (20 calls queued behind a sleeping kernel, CUDA events)
     beside its host-paced time and its bound;
  8. the synthetic-detector serving code at a small size on the card and on
     the CPU (plain versions), same frames and weights: clips within uint8
     +-1 on >= 99.9 %, scores within 5e-3;
  9. the DensePose-detector serving code at a small size (depth 50, pooler
     14, float32) on the card and on the CPU, same frames and weights:
     detections at the CPU tests' bars, then clips and scores as in 8;
 10. K4 sor_solve bit-equal to its plain version at every level shape, on
     the per-op setup's coefficients of 4 pairs from a nonzero flow with
     cold (zero) and warm (random) starts, on random systems at the edge
     shapes and sweep counts of 3, cold and warm, then the 101-pair serving
     batch (timed, with the half-sweeps per launch and time per half-sweep);
 11. K5 warp_bilinear against its plain version at every level shape, on
     flows within, at and far past +-8 px, integer flows and flows across
     the border (max abs error <= 1e-6), then the 101x240x320x3 serving
     batch, timed beside F.grid_sample (the library yardstick);
 12. K6 label_components against its plain version, exactly: part masks at
     56x56 and 112x112, random masks, a serpentine, rounds cut at 1 / 3 /
     7; the strip-boundary shapes (1xW, Hx1, 13x17, 57x76, 112x112, 240x320
     on the cluster; 300x320 and 6x400 in device memory) with the mask
     kinds and caps of 4; then the synthetic CropHTAH masks, 20 x 56x56,
     20 x 112x112 and 20 x 240x320, timed with each mask's executed rounds
     and the time per dependent round;
 13. the per-op flow path on the card against the checked-in goldens
     (tests/goldens; frames regenerated by numpy copies of the golden
     tests' generators): the sinusoid 240x320 and natural 96x128 at +-1 on
     >= 99.9 %, the natural 240x320 at +-2 on >= 99.5 % beyond 8 px of the
     border (the whole-frame fraction is logged); the natural 240x320 on the
     per-op and the fused path within +-1 and +-2, whole frame and beyond
     8 px, logged;
 14. slowfast-HTAH served at full width as in 6 with
     FlowParams(fuse_level="off"): K4, K5 and K2 must launch, K1 and K6
     must not;
 15. the per-op serving code at a small size on the card and on the CPU,
     with n_inner 1 (fuse_level "off") and n_inner 2, at the bars of 8;
 16. slowfast-HTAH trained at full width (bf16 compute, float32 master
     weights) on synthetic clips through engine/trainer.Trainer: batch 16
     (or the largest of 8, 4 that fits), 3 warm-up and 20 timed train steps
     on one batch (ms per step, clips/s, peak memory; the loss finite and
     lower after 10 steps than at the first), then Trainer.train() for one
     epoch of 32 videos with its eval and checkpoint saves;
 17. a fresh Trainer restores that save through tier 1 (equal state_dicts),
     and tier 3 loads a synthesized pytorchvideo-grammar pickle (kept keys
     equal to the file, the mismatched layers left at init);
 18. Trainer at full width from the online backend (synthetic detector,
     default flow): four 130-frame 240x320 train videos and two test videos
     through dataset_factory, train_epoch(0) in DEBUG (one batch of 4) and
     run_eval(); the launch counts are zeroed before and read after each:
     K1 and K2 must launch, K3-K6 must not; the seconds making the clips
     against the step, the eval payload;
 19. a depth-18 train step and eval on the card and on the CPU from the same
     weights, batch and crop offsets (float32, TF32 off, dropout 0): loss
     within 1e-4 relative, gradients against float32's measured resolution
     (gradient_gaps), running statistics and eval scores within 5e-3;
 20. each of the six bindings given one malformed input in a child process
     of its own must raise a Python exception; a child ended by a signal
     fails.
Then the ensemble slice:
 21. the five part streams of engine/sparse.PART_YAMLS at full width
     (SlowFast-R50, 249 classes, CLIP_LEN 20, bf16, seeded random weights;
     CropHTAH 192, the arms 128, the hands 64): ResultSaver dumps train and
     test materials through each stream's Trainer from synthetic datasets
     of 8 videos, SparseTrainer trains the fusion for 20 epochs and
     checkpoints (on to 2000 epochs if no test beat accuracy 0), and
     EnsemblePredictor loads that checkpoint and serves the three videos of
     6 through predict_frames, with per-request seconds and per-stream stage
     seconds; the launch counts are zeroed just before and read just after:
     K1 and K2 exactly 5x their counts in 6, K3-K6 none; probs sum to 1;
 22. the five-stream ensemble at depth 18, float32, on the card and on the
     CPU with the same stream and fusion weights: fused probs and per-stream
     scores within 5e-3, the same top-1;
 23. SparseTrainer at full size (P 5, C 249, 35,878 train and 6,271 test
     clips, IsoGD's split sizes, synthesized): ms per epoch over 20 epochs
     at batch 500, test() ms, peak memory, the seconds projected for 2000;
 24. res3d (batch 30, CLIP_LEN 20) and res2d (batch 60, CLIP_LEN 10, a
     50-channel stem), CropHTAH 192, 249 classes, bf16, trained at full
     width on synthetic clips (as 16: ms per step, clips/s, peak memory, a
     falling loss), then each served through Predictor.predict_frames (K1
     and K2 launch, K3-K6 do not);
 25. a depth-18 res3d and res2d train step on the card and on the CPU, at
     the bars of 19, which also admit twice the card's own float32 spread
     (its gradient with the batch rows permuted); the card's float64 step
     within 1e-6 of the CPU's;
 26. ``python -m video_classification_tpu_torch`` in a subprocess on the
     card: sparse-train on 21's materials and tools how-many-classes, both
     exit 0.
Then the offline chain (pipeline/stages, detect/provider, pipeline/frame_io):
 27. the DensePose provider's three resizes (ops/image: OpenCV's
     INTER_LINEAR on uint8 frames and float32 U/V, INTER_NEAREST on
     charts) on the card against the CPU, exactly, at 8 x 480x640 ->
     800x1067 and at box sizes from 1x1 to 480x640; an ArrayFrameIO round
     trip; Cv2FrameIO() raising an ImportError that names ArrayFrameIO where
     cv2 is absent; where cv2 is present, the same resizes and exact 2x
     downscales of 3-8 channels (OpenCV's area rule past 4) against that
     cv2.resize, the cases that differ recorded with its version;
 28. the whole chain at full width through ArrayFrameIO (lossless .npy
     payloads: no JPEG or AVI coding) with the synthetic provider: one
     130-frame 240x320 M_/K_ pair in train and one in test, every stage
     (sample, images, flow, energy, pad, IUV, CSE, crops), seconds per
     stage and files per stage folder, all six crop streams written; the
     launch counts zeroed just before and read just after: K1 (27 calls a
     video) and K2 launch, K3-K6 do not;
 29. padded_to_iuv, then iuv_to_crop, with DensePoseIUVProvider at full
     width (depth 101, ResizeShortestEdge 800/1333, 1000 per level, 1000,
     100 detections, pooler 28, chart_topk 1, batch 8, bfloat16; seeded
     random weights with the stem and box-delta layers scaled,
     profile_preprocess.random_provider) on [28]'s 52 padded frames:
     seconds per frame, K2 and K3 launch, K1 and K4-K6 do not; boxes inside
     the padded frame, labels 0..24 at the best box's size, U and V in
     [0, 1];
 30. the kernels on the calls captured from [28] and [29]: K1 bit-equal on
     one video's 27 calls (its 65-pair 240x320 call timed), K3 exact on
     every call ((8, ~4663) into 1000 slots at 0.7 and (8, 1000) into 100
     at 0.5, both timed), K2 exact on every frame's six box-sized part
     masks (the largest batch timed, with its route and iterations), each
     with its bound;
 31. a 10-frame 64x96 chain (synthetic provider, 2 outers and 4 sweeps) on
     the card and on the CPU: the same files everywhere, everything equal
     but the flow images and flow crops, those within +-1 on >= 99.9 %;
     DensePoseIUVProvider at depth 50, float32, small budgets, card against
     CPU at the detector bars of 9.
Then the v2 slice (v2/, models/raft.py, tools.render_iuv_boxes):
 32. RAFT raft_large at full width: 12 iterations on the flow converter's
     batch of 64 240x320 frame pairs, weights from the synthesized
     torchvision-grammar state_dict saved as a .pth and loaded through
     models/raft_convert.load_raft_checkpoint, in bfloat16 and in float32:
     ms per batch, pairs/s, peak memory, the counted operations' bound; the
     flow finite;
 33. RAFT at 64x96, 12 iterations, float32 (TF32 off), card against CPU:
     the up-flow and the coarse flow within 5e-3, or else the card's float64
     run within 1e-6 of the CPU's and float32 within twice the card's own
     spread; which bar held is printed;
 34. v2-convert's four converters at full width through ArrayFrameIO, one
     130-frame 240x320 M_ video in train and one in test, three runs on
     fresh copies: the variational flow with the synthetic provider, with
     the DensePose provider (profile_preprocess.random_provider), and the
     RAFT flow (float32) with the synthetic provider; seconds per converter
     and per video, files written, [T][25] box pkls; the launch counts zeroed
     just before and read just after each run: K1 (27 calls a video) and K2
     launch in the variational runs, K3 only with DensePose, K1 not with
     RAFT, K4-K6 never; K2's calls in the two variational runs (24 masks a
     frame, at the synthetic 240x320 box in wide words and at the DensePose
     boxes) each held exactly against the plain version, the count compared
     and the largest call's time beside its bound printed;
 35. V2Trainer at full width (depth 50, INPUT_SIZE 192, CLIP_LEN 20, 249
     classes, bf16, SGD; batch 16 or the largest of 8, 4 that fits): 3
     warm-up and 20 timed steps on one batch (ms per step, clips/s, peak
     memory, a falling loss), then train_epoch(0) in DEBUG and run_eval() on
     [34]'s folders;
 36. a 10-frame 64x96 v2 chain on the card and on the CPU: flow videos
     within +-1 on >= 99.9 %, UV videos and box pkls equal, the dataset's
     clips equal in rgb/uv (flow +-1), the 7-channel exact-2x resize equal,
     one depth-18 float32 V2Trainer step at the bars of 19, render_iuv_boxes
     writing equal frames.
Then the parallel slice (native/, parallel/, remat, engine/parallel_streams):
 37. the native clip loader: whether jpeglib.h is found and cv2 encodes
     JPEG on this machine, whether the loader builds (into .torch_ext/native;
     a failed build with jpeglib.h present fails the run); where it builds,
     a full-width JPEG crop-folder fixture (16 CropHTAH videos of 20 frames),
     a Trainer with DATA.BACKEND auto that must take the native loader, the
     decode of a batch of 16 timed against a bf16 train step; where it does
     not, why, and auto reading with cv2;
 38. K3 past N = 8192 (the device-memory route): N = 10000 and 20000, 4
     frames, thresholds 0.7 and 0.5, 1000 slots, exact against the plain
     version, timed beside the bound;
 39. remat at full width (bf16, batch 16): ms per step and peak memory with
     none, '' and 'conv'; the running statistics after one step equal to no
     remat's; then 'conv' at batches 32, 48, 64, 96 until CUDA out of memory
     (the measured limit; any other exception fails);
 40. two gloo ranks sharing the card train slowfast-HTAH at full width
     (float32, global batch 16) for two steps and evaluate: bit-equal to
     each other, matching the one-process run (first loss within 1e-5,
     first gradients and the state at the train bars, the eval exact but
     scores within 5e-3); one NCCL rank (world size 1) trains one step; ms
     per step of each;
 41. `python -m video_classification_tpu_torch train-parallel slowfast-HTAH
     slowfast-Torso` at full width (bf16, batch 16, one epoch of one step)
     against `train` of each in sequence: wall times, each stream's final
     checkpoint within the train bars; conv3d_temporal_sharded over two gloo
     ranks at a res4 conv_a's full-width shape against the unsharded
     convolution (TF32 off).
Then the JAX package's checkpoint files:
 42. slowfast-HTAH (depth 50, 249 classes, CropHTAH 192, CLIP_LEN 20,
     seeded) and a seeded SparseModel (249 x 5) written through
     models/convert.torch_to_flax and utils/flax_msgpack as the files the
     JAX package's save_checkpoint and SparseTrainer.save_ckpt write, at
     their default paths (the file's MB and the seconds to write and to
     read it back, equal to the weights); a Predictor on that root restores
     tier 1 and serves one 130-frame 240x320 request, its scores bit-equal
     to a Predictor given the weights directly; an EnsemblePredictor over
     the five part streams (HTAH tier 1, the four others tier 2 from the
     HTAH file, the fusion from its msgpack file) serves [21]'s three
     videos, its probabilities bit-equal to the ensemble given the same
     weights directly, K1 and K2 launched exactly as in [21].
Then one JSON line describing each kernel (with its launches per online
train step, from 18, per ensemble request, from 21, per offline video, from
28 and 29, and per v2 video, from 34's DensePose run; K1, K2 and K3 with
their offline rows from 30, K2 with its v2 rows from 34, K3 with its rows
past 8192 from 38 and its box-head call alone from 7), the nvidia-smi line, and last {"ok": true,
"device": {...}}. Exits non-zero without a result when CUDA is unavailable.
"""

from __future__ import annotations

import json
import random
import shutil
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 non-tensor FLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
FLOW_FRAC = 0.999
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


def flow_pyramids(dev):
    """Pyramid level shapes of a 240x320 frame and the image pyramids of 4
    coherent-motion frame pairs, from a seed: (shapes, pyr1, pyr2, g), g the
    generator for the phase's further random inputs."""
    import torch

    from video_classification_tpu_torch.ops.flow import (
        DEFAULT_PARAMS as p, _gaussian_blur, _pyramid_shapes, _resize_bilinear)
    from video_classification_tpu_torch.utils.synthetic import coherent_motion_frames

    g = torch.Generator().manual_seed(1)
    frames = coherent_motion_frames(5, 240, 320, g).to(dev).float() / 255.0
    shapes = _pyramid_shapes(240, 320, p.ratio, p.min_width)
    sigma = (1.0 / p.ratio - 1.0) + 0.3
    pyr1, pyr2 = [frames[:-1].contiguous()], [frames[1:].contiguous()]
    for hw in shapes[1:]:
        pyr1.append(_resize_bilinear(_gaussian_blur(pyr1[-1], sigma), hw))
        pyr2.append(_resize_bilinear(_gaussian_blur(pyr2[-1], sigma), hw))
    return shapes, pyr1, pyr2, g


def smooth_noise(g, b: int, h: int, w: int, scale: float):
    """(b, h, w) smooth random field: 6x8 normal noise upsampled, x scale."""
    import torch
    import torch.nn.functional as F

    noise = torch.randn((b, 1, 6, 8), generator=g)
    return F.interpolate(noise, (h, w), mode="bilinear", align_corners=False)[:, 0] * scale


SERVING_PAIRS = 101  # one clip window's frame pairs per flow call


def serving_batch(pyr, lvl: int):
    """The level's 4 pairs repeated to the serving batch."""
    rep = -(-SERVING_PAIRS // pyr[lvl].shape[0])
    return pyr[lvl].repeat(rep, 1, 1, 1)[:SERVING_PAIRS].contiguous()


def bound(ops: float, nbytes: float):
    """(bound ms, what bounds it) on the H100 SXM peaks."""
    t_ops, t_bytes = ops / PEAK_F32_OPS_PER_S, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


# Edge shapes and sweep counts of the SOR tiles (tests/test_torch_port_sor_tiles.py):
# 64x64 is the largest frame that runs whole, 65x64 and 64x65 the first
# tiled ones; n_sor around the HALF_SWEEPS / 2 sweeps of one tiled launch.
EDGE_SHAPES = ((2, 2), (7, 9), (24, 32), (57, 76), (64, 64), (65, 64), (64, 65),
               (76, 101), (101, 135), (240, 320))


def edge_sweeps():
    from video_classification_tpu_torch.ops.sor_solve import HALF_SWEEPS

    return (1, HALF_SWEEPS // 2 - 1, HALF_SWEEPS // 2, HALF_SWEEPS // 2 + 1, 30)


def require_equal(what, got, want) -> float:
    """The largest |got - want| over the tensor pairs, which must be 0 with
    every pair bit-equal (NaNs included), else an AssertionError."""
    import torch

    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    if err != 0.0 or not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{what}: max |kernel - plain| {err}, not bit-equal")
    return err


def sor_schedule_row(run, h: int, w: int, n_sor: int, solves: int):
    """The SOR tiles' schedule at h x w (ops/sor_solve.py) and the device ms
    per half-sweep: run(n) makes `solves` solves of n sweeps; the time of
    n_sor sweeps less that of one tiled launch's (HALF_SWEEPS / 2), over the
    half-sweeps between them."""
    from video_classification_tpu_torch.ops.sor_solve import HALF_SWEEPS, whole_frame

    whole = whole_frame(h, w)
    per_launch = 2 * n_sor if whole else HALF_SWEEPS
    short = HALF_SWEEPS // 2
    diff = cuda_ms(lambda: run(n_sor)) - cuda_ms(lambda: run(short))
    return {"whole_frame": whole, "half_sweeps_per_launch": per_launch,
            "tile_launches_per_solve": -(-2 * n_sor // per_launch),
            "ms_per_half_sweep": round(diff / (solves * 2 * (n_sor - short)), 5)}


def check_flow_level(dev, pyramids):
    """K1 bit-equal to its plain version (u, v, mx) at every level (4 pairs
    from a nonzero flow, then the 101-pair serving batch from zero flow,
    timed) and at the SOR tiles' edge shapes and sweep counts."""
    import torch

    from video_classification_tpu_torch.ops.flow import FlowParams
    from video_classification_tpu_torch.ops.flow_level import (
        flow_level, flow_level_reference)

    p = FlowParams()
    tail = (p.alpha, p.omega, p.eps, p.warp_radius, p.fuse_outer_tol)
    args = (p.n_sor, *tail)
    shapes, pyr1, pyr2, g = pyramids

    worst = [0.0]

    def exact(what, *call):
        worst[0] = max(worst[0], require_equal(
            f"K1 {what}", flow_level(*call), flow_level_reference(*call)))
        log(f"  K1 {what}: bit-equal (u, v, mx)")

    for lvl, (h, w) in enumerate(shapes):
        u0, v0 = (smooth_noise(g, 4, h, w, 1.5).to(dev) for _ in range(2))
        exact(f"{h}x{w} x4, nonzero start", pyr1[lvl], pyr2[lvl], u0, v0, p.n_outer, *args)
    for h, w in EDGE_SHAPES:
        im1, im2 = (torch.rand((2, h, w, 3), generator=g).to(dev) for _ in range(2))
        u0, v0 = (smooth_noise(g, 2, h, w, 1.0).to(dev) for _ in range(2))
        for n_sor in edge_sweeps():
            exact(f"{h}x{w} x2, 2 outers, n_sor {n_sor}", im1, im2, u0, v0, 2, n_sor, *tail)

    # The serving batch: one clip window's 101 frame pairs per call.
    b = SERVING_PAIRS
    levels = []
    for lvl, (h, w) in enumerate(shapes):
        a1, a2 = serving_batch(pyr1, lvl), serving_batch(pyr2, lvl)
        z = torch.zeros((b, h, w), device=dev)
        exact(f"{h}x{w} x{b}, zero start", a1, a2, z, z, p.n_outer, *args)
        ms = cuda_ms(lambda: flow_level(a1, a2, z, z, p.n_outer, *args))
        _, plain_ms = cuda_call_ms(
            lambda: flow_level_reference(a1, a2, z, z, p.n_outer, *args))
        outers = int(executed_outers(
            lambda k: flow_level(a1, a2, z, z, k, *args), p.n_outer).sum())
        ops = outers * h * w * flow_ops_per_pixel_outer(3, p.n_sor)
        bound_ms, bound_by = bound(ops, (2 * a1.numel() + 4 * z.numel() + b) * 4)
        # Per half-sweep with every outer run (outer_tol -1: no early exit).
        sched = sor_schedule_row(
            lambda n: flow_level(a1, a2, z, z, p.n_outer, n, *tail[:-1], -1.0),
            h, w, p.n_sor, p.n_outer)
        row = {"level": f"{h}x{w}", "pairs": b, "ms": round(ms, 4),
               "outers": outers, "bound_ms": round(bound_ms, 4),
               "bound_by": bound_by, "plain_ms": round(plain_ms, 4), **sched}
        levels.append(row)
        log(f"  K1 time {json.dumps(row)}")
    return {"max_abs_err": worst[0], "levels": levels, **levels[0]}


def executed_rounds_per_mask(reference, masks, cap: int):
    """Rounds each mask's propagation executes when it stops at its own
    fixed point: the fewest k after which reference(masks, k) (k rounds at
    most; a tuple of tensors) no longer changes, found by bisection, plus
    the last round, which sees no change; at most cap. The masks sharing a
    bisection step share its call."""
    import torch

    want = reference(masks, cap)
    lo, hi = [0] * masks.shape[0], [cap] * masks.shape[0]
    while any(a < b for a, b in zip(lo, hi)):
        steps = {}
        for i, (a, b) in enumerate(zip(lo, hi)):
            if a < b:
                steps.setdefault((a + b) // 2, []).append(i)
        for mid, idx in steps.items():
            got = reference(masks[idx], mid)
            for j, i in enumerate(idx):
                if all(torch.equal(g[j], w[i]) for g, w in zip(got, want)):
                    hi[i] = mid
                else:
                    lo[i] = mid + 1
    return [min(a + 1, cap) for a in lo]


def serpentine(h: int, w: int):
    import torch

    m = torch.zeros((h, w), dtype=torch.bool)
    m[0::2] = True
    for i, r in enumerate(range(1, h, 2)):
        m[r, w - 1 if i % 2 == 0 else 0] = True
    return m


def strip_masks(kind: str, h: int, w: int, g):
    """The K2 strip-boundary masks of tests/test_torch_port_extents_cluster.py:
    random, sparse, empty, chart and serpentines across every column and
    down every row (so across every CTA's strip)."""
    import torch

    from video_classification_tpu_torch.config.crop_cfg import crop_part_args
    from video_classification_tpu_torch.ops.components import part_mask
    from video_classification_tpu_torch.pipeline.online import SyntheticOnlineDetector

    if kind == "random":
        return torch.rand((h, w), generator=g) < 0.45
    if kind == "sparse":
        return torch.rand((h, w), generator=g) < 0.15
    if kind == "empty":
        return torch.zeros((h, w), dtype=torch.bool)
    if kind == "serpentine":
        return serpentine(h, w)
    if kind == "serpentine_vertical":
        return serpentine(w, h).T.contiguous()
    charts = torch.from_numpy(SyntheticOnlineDetector(max(h, w))._charts())
    return part_mask(charts, crop_part_args[0][0])[:h, :w].contiguous()


def resized(charts, h: int, w: int):
    """(..., H0, W0) charts nearest-resized to h x w (source index
    floor(i * H0 / h), as cv2.INTER_NEAREST re-rasterises a chart to its
    person box in the JAX package's detect/provider.py)."""
    import torch

    h0, w0 = charts.shape[-2:]
    ys = torch.arange(h, device=charts.device) * h0 // h
    xs = torch.arange(w, device=charts.device) * w0 // w
    return charts[..., ys, :][..., xs]


def part_masks(chart):
    """The six crop streams' part masks of one (H, W) chart, (6, H, W)."""
    import torch

    from video_classification_tpu_torch.config.crop_cfg import crop_part_args
    from video_classification_tpu_torch.ops.components import part_mask

    return torch.stack([part_mask(chart, ids) for ids, _ in crop_part_args]).contiguous()


def synthetic_part_masks(h: int, w: int, dev, n: int = 20):
    """n copies of the CropHTAH part mask of the synthetic detector's
    charts, made at 112x112 and nearest-resized to h x w unless square."""
    import torch

    from video_classification_tpu_torch.config.crop_cfg import crop_part_args
    from video_classification_tpu_torch.ops.components import part_mask
    from video_classification_tpu_torch.pipeline.online import SyntheticOnlineDetector

    charts = torch.from_numpy(SyntheticOnlineDetector(h if h == w else 112)._charts())
    if h != w:
        charts = resized(charts, h, w)
    return part_mask(charts, crop_part_args[0][0]).expand(n, h, w).contiguous().to(dev)


def time_extents(what, masks, fields_per_pass, route):
    """K2's device time on ``masks`` beside its plain version's, each
    mask's executed iterations (per pass of ``fields_per_pass`` fields, the
    fields of one word), the bound and the time per dependent iteration."""
    from video_classification_tpu_torch.ops.component_extents import (
        component_extents, component_extents_reference)

    b, h, w = masks.shape
    ms = cuda_ms(lambda: component_extents(masks), reps=20)
    _, plain = cuda_call_ms(lambda: component_extents_reference(masks))
    fg = (masks != 0).flatten(1).sum(1).tolist()
    passes = []
    for f in range(0, 4, fields_per_pass):
        def reference(m, k, f=f):
            return component_extents_reference(m, k)[f:f + fields_per_pass]
        passes.append(executed_rounds_per_mask(reference, masks, h + w))
    # Each foreground pixel's separable 3x3 minimum per executed iteration
    # of its mask and pass: 2 vertical and 2 horizontal minima of one word
    # (byte-wise or halfword-wise) and the change test, at the f32 rate.
    ops = 5 * sum(n * k for its in passes for n, k in zip(fg, its))
    bound_ms, bound_by = bound(ops, b * h * w * (1 + 16))
    slowest = max(max(its) for its in passes)
    row = {"masks": what, "ms": round(ms, 4), "plain_ms": round(plain, 4),
           "iters": [min(min(its) for its in passes), slowest], "fg_pixels": sum(fg),
           "us_per_round": round(1e3 * ms / slowest, 3) if slowest else None,
           "bound_ms": bound_ms, "bound_by": bound_by, "route": route}
    log(f"  K2 time {json.dumps(row)}")
    return row


def check_component_extents(dev, densepose_charts):
    """K2 against its plain version, exactly: charts, random masks and
    serpentines at 56x56 and 112x112, the strip-boundary shapes and
    iteration caps of the narrow words (up to 255x255) and of the wide ones
    (past 255 px a side, on the cluster and in device memory, up to
    480x640); then timed: the synthetic charts' CropHTAH masks at 56x56 and
    112x112, the six crop streams' part masks of the first of
    ``densepose_charts`` (the DensePose detector's own 112x112 charts)
    nearest-resized to 240x320 and 480x640 (the wide words), and the CropHTAH
    masks of all of them (the serving batch; the kernel's row)."""
    import torch

    from video_classification_tpu_torch.config.crop_cfg import crop_part_args
    from video_classification_tpu_torch.ops.component_extents import (
        CLUSTER, ITERS_PER_SYNC, component_extents, component_extents_reference)
    from video_classification_tpu_torch.ops.components import part_mask
    from video_classification_tpu_torch.pipeline.online import SyntheticOnlineDetector
    from video_classification_tpu_torch.utils.cuda import build

    route = build().component_extents_route

    def exact(what, masks, max_iters=None, log_it=True):
        """Max |kernel - plain| over the four fields; fails unless 0."""
        err = max(int((a.long() - b.long()).abs().max()) for a, b in
                  zip(component_extents(masks, max_iters),
                      component_extents_reference(masks, max_iters)))
        if err != 0:
            raise AssertionError(f"K2 {what}: max |kernel - plain| {err}")
        if log_it:
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
    # The strip-boundary shapes, mask kinds and iteration caps of the CPU
    # emulation (S = ITERS_PER_SYNC iterations per exchange): the narrow
    # words up to 255x255, the wide ones past it, on the cluster up to 320
    # columns while the strips fit shared memory, else in device memory.
    kinds = ("random", "sparse", "empty", "charts", "serpentine", "serpentine_vertical")
    S = ITERS_PER_SYNC
    for h, w in ((1, 37), (29, 1), (1, 255), (255, 1), (13, 17), (57, 76), (112, 112),
                 (255, 255), (1, 256), (256, 1), (257, 300), (240, 320), (300, 320),
                 (4, 330), (480, 640)):
        masks = torch.stack([strip_masks(k, h, w, g) for k in kinds]).to(dev)
        caps = sorted({0, 1, 2, S - 1, S, S + 1, h + w - 1, h + w})
        for cap in caps:
            max_err = max(max_err, exact(f"{h}x{w}", masks, cap, log_it=False))
        log(f"  K2 {h}x{w} ({route(h, w)} words) {', '.join(kinds)}, max_iters {caps}: exact")
    want = {(255, 255): "narrow", (1, 256): "wide", (240, 320): "wide",
            (300, 320): "device", (480, 640): "device"}
    if any(route(*hw) != r for hw, r in want.items()):
        raise AssertionError(f"K2 routes {[route(*hw) for hw in want]}, expected "
                             f"{list(want.values())}")

    timed = {f"synthetic 20x{hm}x{hm} serving masks": synthetic_part_masks(hm, hm, dev)
             for hm in (56, 112)}
    for h, w in ((240, 320), (480, 640)):
        timed[f"densepose chart resized, 6 parts x{h}x{w}"] = part_masks(
            resized(densepose_charts[0], h, w))
    serving = part_mask(densepose_charts, crop_part_args[0][0]).contiguous()
    timed[f"densepose {'x'.join(map(str, serving.shape))} serving masks"] = serving
    rows = []
    for what, masks in timed.items():
        max_err = max(max_err, exact(what, masks))
        h, w = masks.shape[1:]
        words = route(h, w)
        rows.append(time_extents(what, masks, 4 if words == "narrow" else 2, words))
    return {**rows[-1], "rows": rows, "max_abs_err": max_err,
            "cluster": CLUSTER, "iters_per_sync": ITERS_PER_SYNC}


def nms_boxes(n: int, seed: int, extent: float):
    """n random xyxy boxes and scores from a numpy seed (the CPU tests')."""
    import numpy as np

    rng = np.random.RandomState(seed)
    centers = rng.rand(n, 2) * extent
    sizes = 4 + rng.rand(n, 2) * extent / 3
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], 1)
    return boxes.astype(np.float32), rng.rand(n).astype(np.float32)


def suppressed_chunk_case():
    """Chunk 1: 64 disjoint boxes; chunk 2: a shifted copy of each, which
    its original suppresses; chunk 3: new disjoint boxes (the CPU tests')."""
    import numpy as np

    grid = np.stack(np.meshgrid(np.arange(8), np.arange(8)), -1).reshape(64, 2) * 20.0
    first = np.concatenate([grid, grid + 10.0], 1).astype(np.float32)
    boxes = np.concatenate([first, first + np.float32(0.5), first + np.float32(400.0)])
    scores = np.concatenate([np.linspace(0.99, 0.8, 64), np.linspace(0.79, 0.6, 64),
                             np.linspace(0.59, 0.4, 64)]).astype(np.float32)
    return boxes, scores


def nms_scan_ops(scores, idx, mask, n_pad_min: int = 64, chunk: int = 64) -> int:
    """Operations of K3's sorted scan on these inputs, counted from the
    kernel: the bitonic sort of the padded keys (3 per compare-exchange)
    and 13 per IoU test (min, max, sub, max per axis; mul; add, sub, max;
    div) in the chunks the scan reached: each live candidate against the
    boxes kept before its chunk, and the chunk's 64 x 63 / 2 pairs. The
    chunks reached end with the one holding the last kept box when all
    slots filled, else with the one holding the first score <= NEG/2."""
    import torch

    from video_classification_tpu_torch.detect.nms import NEG

    bsz, n = scores.shape
    n_pad = max(n_pad_min, 1 << (n - 1).bit_length())
    stages = n_pad.bit_length() - 1
    ops = bsz * (n_pad // 2) * stages * (stages + 1) // 2 * 3
    s = scores.float().cpu() + 0.0  # -0.0 ties with +0.0
    order = torch.sort(-s, dim=1, stable=True).indices
    pos = torch.argsort(order, dim=1)
    for f in range(bsz):
        valid = int((s[f] > NEG * 0.5).sum())
        kept = pos[f, idx[f].long().cpu()][mask[f].cpu()]
        if mask[f].all():
            chunks = int(kept.max()) // chunk + 1
        else:
            chunks = min(valid // chunk + 1, -(-n // chunk))
        for c in range(chunks):
            live = max(0, min(valid, (c + 1) * chunk) - c * chunk)
            ops += 13 * (live * int((kept < c * chunk).sum()) + chunk * (chunk - 1) // 2)
    return ops


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
    # The chunks of the sorted scan hold 64 candidates: sizes on both sides
    # of one and two chunks, and the sizes of the serving calls.
    for n in (1, 20, 63, 64, 65, 127, 129, 1264):
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
    boxes, scores = nms_boxes(200, 5, 600.0)
    err = max(err, case("max_out 37 reached inside the first chunk", boxes, scores, 37, 0.5))
    err = max(err, case("a chunk the kept boxes suppress entirely",
                        *suppressed_chunk_case(), 150, 0.5))
    b80 = np.concatenate([b16] * 5)
    s80 = np.concatenate([s16, s16[::-1], s16, np.full(16, 0.5, np.float32), -s16])
    s80[[3, 20, 40, 41]] = [-0.0, 0.0, -np.inf, NEG]
    err = max(err, case("ties, +-0.0, -inf and NEG", b80, s80, 80, 0.5))
    boxes, scores = nms_boxes(150, 7, 2000.0)
    scores[70:] = NEG
    err = max(err, case("scores at NEG from the second chunk on", boxes, scores, 140, 0.5))
    boxes, scores = nms_boxes(5000, 4, 800.0)
    err = max(err, case("N 5000 max_out 100 (provider budget)", boxes, scores, 100, 0.7))
    boxes, scores = nms_boxes(8192, 6, 1600.0)
    err = max(err, case("N 8192 max_out 300 (the most one block holds)", boxes, scores, 300, 0.7))

    rows = [nms_row("serving", *call) for call in serving_calls]
    if {r["batch"] for r in rows} != {"20x1264", "20x64"}:
        raise AssertionError(f"K3: serving batches {[r['batch'] for r in rows]}")
    return {**rows[0], "rows": rows, "max_abs_err": err}


def nms_row(what, boxes, scores, max_out, thr, timed: bool = True):
    """K3 on one captured call: exact against its plain version (indices
    and mask), then (if ``timed``) timed beside it, with the bound of the
    work this data needs."""
    import torch

    from video_classification_tpu_torch.detect.nms import nms, nms_reference

    bsz, n = scores.shape
    what = f"{what} {bsz}x{n} thr {thr} max_out {max_out}"
    (ki, km), (ri, rm) = nms(boxes, scores, max_out, thr), nms_reference(
        boxes, scores, max_out, thr)
    if not (torch.equal(ki, ri) and torch.equal(km, rm) and ki.dtype == torch.int32):
        raise AssertionError(f"K3 {what}: kernel and plain differ")
    if not timed:
        return None
    ms = cuda_ms(lambda: nms(boxes, scores, max_out, thr), reps=20)
    (_, mask), plain = cuda_call_ms(lambda: nms_reference(boxes, scores, max_out, thr))
    # The work this data needs: the sort and the chunks the scan reached.
    # The real limit is latency (the sort's and the chunks' barriers); the
    # bound counts only operations and bytes.
    ops = nms_scan_ops(scores, ki, km)
    bound_ms, bound_by = bound(ops, bsz * n * 20 + bsz * max_out * 5)
    row = {"batch": f"{bsz}x{n}", "thr": thr, "max_out": max_out,
           "kept": int(mask.sum()), "ops": ops, "ms": round(ms, 4),
           "plain_ms": round(plain, 4), "bound_ms": bound_ms, "bound_by": bound_by}
    log(f"  K3 {what}: exact; time {json.dumps(row)}")
    return row



def sor_ops_per_pixel(n_sor: int) -> int:
    """f32 operations of K4 per pixel, counted from the kernel: setup 27
    (wsum 3, two reciprocal diagonals 6, two constant smoothness terms 18),
    32 per sweep (du and dv, 16 each)."""
    return 27 + 32 * n_sor


def warp_ops_per_pixel(c: int) -> int:
    """f32 operations of K5 per pixel, counted from the kernel: coordinates,
    clamps, base corner and weights 14; per channel 8 products and 3 sums."""
    return 14 + 11 * c


def random_system(g, b: int, h: int, w: int, warm: bool, dev):
    """Normal equations with a coupling a12, Charbonnier-like edge weights
    zero across the border, a flow (u, v) and a cold or random warm start,
    as in tests/test_torch_port_sor_solve.py."""
    import torch

    from video_classification_tpu_torch.ops.flow_level import _edge_weights

    def f():
        return torch.rand((b, h, w), generator=g)

    a11, a22, a12 = 0.5 + f(), 0.5 + f(), (f() - 0.5) * 0.6
    b1, b2 = torch.randn((b, h, w), generator=g), torch.randn((b, h, w), generator=g)
    weights = _edge_weights(0.2 + 2.0 * f())
    u, v = (f() - 0.5) * 6.0, (f() - 0.5) * 6.0
    du0, dv0 = ((f() - 0.5) * 0.5, (f() - 0.5) * 0.5) if warm else (0 * u, 0 * u)
    return [t.contiguous().to(dev) for t in (a11, a12, a22, b1, b2, *weights, u, v, du0, dv0)]


def check_sor_solve(dev, pyramids):
    """K4 bit-equal to its plain version on the per-op setup's coefficients
    at every level: 4 pairs from a nonzero flow, cold (zero) and warm
    (random) starts; on random systems at the SOR tiles' edge shapes and
    sweep counts; then the 101-pair serving batch from zero flow, timed."""
    import torch

    from video_classification_tpu_torch.ops.flow import (
        FlowParams, _normal_equations, _outer_terms)
    from video_classification_tpu_torch.ops.sor_solve import (
        sor_solve, sor_solve_reference)

    p = FlowParams()
    shapes, pyr1, pyr2, g = pyramids

    worst = [0.0]

    def exact(what, args):
        worst[0] = max(worst[0], require_equal(
            f"K4 {what}", sor_solve(*args), sor_solve_reference(*args)))
        log(f"  K4 {what}: bit-equal")

    def level_args(ix, iy, it, u, v, du0, dv0):
        coeffs = _normal_equations(ix, iy, it, u, v, du0, dv0, p.eps)
        return (*coeffs, u, v, p.n_sor, p.alpha, p.omega, du0, dv0)

    for lvl, (h, w) in enumerate(shapes):
        u0, v0 = (smooth_noise(g, 4, h, w, 1.5).to(dev) for _ in range(2))
        terms = _outer_terms(pyr1[lvl], pyr2[lvl], u0, v0)
        z = torch.zeros_like(u0)
        exact(f"{h}x{w} x4, cold start", level_args(*terms, u0, v0, z, z))
        du0, dv0 = (smooth_noise(g, 4, h, w, 0.3).to(dev) for _ in range(2))
        exact(f"{h}x{w} x4, warm start", level_args(*terms, u0, v0, du0, dv0))
    for h, w in EDGE_SHAPES:
        for warm in (False, True):
            t = random_system(g, 2, h, w, warm, dev)
            for n_sor in edge_sweeps():
                exact(f"{h}x{w} x2, {'warm' if warm else 'cold'}, n_sor {n_sor}",
                      (*t[:11], n_sor, 0.012, 1.8, t[11], t[12]))

    b = SERVING_PAIRS
    levels = []
    for lvl, (h, w) in enumerate(shapes):
        z = torch.zeros((b, h, w), device=dev)
        terms = _outer_terms(serving_batch(pyr1, lvl), serving_batch(pyr2, lvl), z, z)
        args = level_args(*terms, z, z, z, z)
        del terms
        exact(f"{h}x{w} x{b}, zero flow", args)
        ms = cuda_ms(lambda: sor_solve(*args))
        _, plain_ms = cuda_call_ms(lambda: sor_solve_reference(*args))
        bound_ms, bound_by = bound(b * h * w * sor_ops_per_pixel(p.n_sor),
                                   15 * b * h * w * 4)
        sched = sor_schedule_row(lambda n: sor_solve(*args[:11], n, *args[12:]),
                                 h, w, p.n_sor, 1)
        row = {"level": f"{h}x{w}", "pairs": b, "ms": round(ms, 4),
               "bound_ms": round(bound_ms, 4), "bound_by": bound_by,
               "plain_ms": round(plain_ms, 4), **sched}
        levels.append(row)
        log(f"  K4 time {json.dumps(row)}")
    return {"max_abs_err": worst[0], "levels": levels, **levels[0]}


def check_warp(dev, pyramids):
    """K5 against its plain version at every level on flows within, at and
    far past +-8 px, integer flows and flows across the border; then the
    101-pair serving batch at 240x320, timed, beside F.grid_sample."""
    import torch
    import torch.nn.functional as F

    from video_classification_tpu_torch.ops.warp import (
        warp_bilinear, warp_bilinear_reference)

    shapes, _, pyr2, g = pyramids
    max_err = 0.0

    def exact(what, im, u, v):
        err = float((warp_bilinear(im, u, v) - warp_bilinear_reference(im, u, v)).abs().max())
        if err > 1e-6:
            raise AssertionError(f"K5 {what}: max |kernel - plain| {err}")
        return err

    for lvl, (h, w) in enumerate(shapes):
        im = pyr2[lvl]
        rand = torch.rand((2, 4, h, w), generator=g).to(dev) - 0.5
        ys = torch.arange(h, device=dev, dtype=torch.float32).view(1, h, 1).expand(4, h, w)
        xs = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, w).expand(4, h, w)
        cases = {
            "within +-8": (rand[0] * 16, rand[1] * 16),
            "at +-8": (torch.sign(rand[0]) * 8, torch.sign(rand[1]) * 8),
            "far past (+-60)": (rand[0] * 120, rand[1] * 120),
            "integer": (torch.round(rand[0] * 20), torch.round(rand[1] * 20)),
            # onto the last row / column, past it, and past the first
            "border": (torch.where(xs < w // 2, -xs - 1.5, w - 1 - xs + 2 * rand[0]),
                       torch.where(ys < h // 2, -ys + rand[1], h - 1 - ys + 3.0)),
        }
        errs = {k: exact(f"{h}x{w} {k}", im, u.contiguous(), v.contiguous())
                for k, (u, v) in cases.items()}
        max_err = max(max_err, *errs.values())
        log(f"  K5 {h}x{w} x4: max |kernel - plain| "
            + ", ".join(f"{k} {e:.1e}" for k, e in errs.items()))

    b, (h, w) = SERVING_PAIRS, shapes[0]
    im = serving_batch(pyr2, 0)
    u, v = (smooth_noise(g, b, h, w, 2.0).to(dev) for _ in range(2))
    max_err = max(max_err, exact(f"{h}x{w} x{b}", im, u, v))
    ms = cuda_ms(lambda: warp_bilinear(im, u, v), reps=20)
    want, plain_ms = cuda_call_ms(lambda: warp_bilinear_reference(im, u, v))
    # The library yardstick: grid_sample on the NCHW image with a prebuilt
    # grid (align_corners=True maps -1..1 onto pixel centres 0..W-1; border
    # padding clamps), which the port never calls.
    nchw = im.permute(0, 3, 1, 2).contiguous()
    gx = (torch.arange(w, device=dev).view(1, 1, w) + u) * (2.0 / (w - 1)) - 1.0
    gy = (torch.arange(h, device=dev).view(1, h, 1) + v) * (2.0 / (h - 1)) - 1.0
    grid = torch.stack([gx, gy], -1)

    def library():
        return F.grid_sample(nchw, grid, mode="bilinear", padding_mode="border",
                             align_corners=True)

    library_ms = cuda_ms(library, reps=20)
    lib_err = float((library().permute(0, 2, 3, 1) - want).abs().max())
    c = im.shape[-1]
    bound_ms, bound_by = bound(b * h * w * warp_ops_per_pixel(c),
                               (2 * c + 2) * b * h * w * 4)
    row = {"batch": f"{b}x{h}x{w}x{c}", "ms": round(ms, 4),
           "plain_ms": round(plain_ms, 4), "library_ms": round(library_ms, 4),
           "library_max_abs_diff": lib_err, "bound_ms": round(bound_ms, 4),
           "bound_by": bound_by}
    log(f"  K5 time {json.dumps(row)}")
    return {**row, "max_abs_err": max_err}


def check_label_components(dev):
    """K6 against its plain version, exactly: the synthetic detector's part
    masks, random masks, a serpentine and rounds cut short at 56x56 and
    112x112; the strip-boundary shapes, mask kinds and caps of the CPU
    emulation up to 240x320 (on the cluster) and past it (device memory);
    then timed: the synthetic CropHTAH masks, 20 x 56x56, 20 x 112x112 and,
    nearest-resized, 20 x 240x320."""
    import torch

    from video_classification_tpu_torch.config.crop_cfg import crop_part_args
    from video_classification_tpu_torch.ops.components import part_mask
    from video_classification_tpu_torch.ops.label_components import (
        label_components, label_components_reference)
    from video_classification_tpu_torch.pipeline.online import SyntheticOnlineDetector
    from video_classification_tpu_torch.ops.component_extents import ITERS_PER_SYNC
    from video_classification_tpu_torch.utils.cuda import build

    route = build().label_components_route

    def exact(what, masks, max_iters=None, log_it=True):
        got = label_components(masks, max_iters)
        want = label_components_reference(masks, max_iters)
        err = int((got.long() - want.long()).abs().max())
        if err != 0 or got.dtype != torch.int32:
            raise AssertionError(f"K6 {what}: max |kernel - plain| {err}")
        if log_it:
            log(f"  K6 {what}: exact")
        return err

    g = torch.Generator().manual_seed(4)
    for hm in (56, 112):
        charts = torch.from_numpy(SyntheticOnlineDetector(hm)._charts())
        random45 = torch.rand((32, hm, hm), generator=g) < 0.45
        cases = {
            "charts": torch.stack([part_mask(charts, ids) for ids, _ in crop_part_args]),
            "random0.45": random45,
            "random0.25": torch.rand((32, hm, hm), generator=g) < 0.25,
            "serpentine": serpentine(hm, hm)[None],
        }
        for name, masks in cases.items():
            exact(f"{hm}x{hm} {name} x{masks.shape[0]}", masks.to(dev))
        for cut in (1, 3, 7):
            exact(f"{hm}x{hm} random0.45 x32, max_iters {cut}", random45.to(dev), cut)
            exact(f"{hm}x{hm} serpentine, max_iters {cut}", serpentine(hm, hm)[None].to(dev), cut)
    kinds = ("random", "sparse", "empty", "charts", "serpentine", "serpentine_vertical")
    S = ITERS_PER_SYNC
    for h, w in ((1, 37), (29, 1), (1, 320), (240, 1), (13, 17), (57, 76), (112, 112),
                 (240, 320), (300, 320), (6, 400)):
        masks = torch.stack([strip_masks(k, h, w, g) for k in kinds]).to(dev)
        caps = sorted({0, 1, 2, S - 1, S, S + 1, h + w - 1, h + w})
        for cap in caps:
            exact(f"{h}x{w}", masks, cap, log_it=False)
        log(f"  K6 {h}x{w} ({route(h, w)}) {', '.join(kinds)}, max_iters {caps}: exact")
    want = {(240, 320): "cluster", (300, 320): "device", (6, 400): "device"}
    if any(route(*hw) != r for hw, r in want.items()):
        raise AssertionError(f"K6 routes {[route(*hw) for hw in want]}, expected "
                             f"{list(want.values())}")

    rows = []
    for h, w in ((56, 56), (112, 112), (240, 320)):
        masks = synthetic_part_masks(h, w, dev)
        exact(f"{h}x{w} serving masks x20", masks)
        rows.append(time_labels(f"20x{h}x{w}", masks, route(h, w)))
    # The kernel's row: 112x112, the DensePose detector's chart size.
    return {**rows[1], "rows": rows, "max_abs_err": 0}


def time_labels(what, masks, route):
    """K6's device time on ``masks`` beside its plain version's, each
    mask's executed rounds, the bound and the time per dependent round."""
    from video_classification_tpu_torch.ops.label_components import (
        label_components, label_components_reference)

    b, h, w = masks.shape
    ms = cuda_ms(lambda: label_components(masks), reps=20)
    _, plain = cuda_call_ms(lambda: label_components_reference(masks))
    rounds = executed_rounds_per_mask(lambda m, k: (label_components_reference(m, k),),
                                      masks, h + w)
    # Each foreground pixel's separable 3x3 minimum per executed round of
    # its mask: 2 vertical and 2 horizontal minima and the change test,
    # counted at the f32 rate as for K2; the mask in, the labels out.
    fg = (masks != 0).flatten(1).sum(1).tolist()
    ops = 5 * sum(n * k for n, k in zip(fg, rounds))
    bound_ms, bound_by = bound(ops, b * h * w * (1 + 4))
    row = {"masks": what, "ms": round(ms, 4), "plain_ms": round(plain, 4),
           "rounds": [min(rounds), max(rounds)], "fg_pixels": sum(fg),
           "us_per_round": round(1e3 * ms / max(rounds), 3) if max(rounds) else None,
           "bound_ms": bound_ms, "bound_by": bound_by, "route": route}
    log(f"  K6 time {json.dumps(row)}")
    return row


def make_frames(seed=0, t=3, h=240, w=320):
    """numpy copy of tests/test_flow_golden.make_frames: the sinusoid
    golden's frames."""
    import numpy as np

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for k in range(t):
        dx, dy = 1.7 * k, -1.1 * k
        f = (127 + 60 * np.sin((xx - dx) / 23.0) * np.cos((yy - dy) / 17.0)
             + 40 * np.sin(((xx - dx) + (yy - dy)) / 41.0))
        f = f[..., None].repeat(3, -1) + rng.randn(h, w, 3) * 2.0
        frames.append(np.clip(f, 0, 255).astype(np.uint8))
    return np.stack(frames)


def make_natural_frames(seed=7, t=3, h=240, w=320, shift=(2.3, -1.4)):
    """numpy copy of tests/test_flow_golden.make_natural_frames: a 1/f^2
    random field, subpixel-translated per frame, plus noise."""
    import numpy as np

    rng = np.random.RandomState(seed)
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    radius = np.sqrt(fy * fy + fx * fx)
    radius[0, 0] = 1.0
    spectrum = (rng.randn(h, w) + 1j * rng.randn(h, w)) / radius
    frames = []
    for k in range(t):
        dx, dy = shift[0] * k, shift[1] * k
        phase = np.exp(-2j * np.pi * (fx * dx + fy * dy))
        field = np.fft.ifft2(spectrum * phase).real
        field = (field - field.min()) / (field.max() - field.min() + 1e-9)
        f = 20 + 215 * field
        f = f[..., None].repeat(3, -1) + rng.randn(h, w, 3) * 2.0
        frames.append(np.clip(f, 0, 255).astype(np.uint8))
    return np.stack(frames)


def check_goldens(dev):
    """The per-op path on the card against the checked-in flow goldens,
    which the JAX package's per-op path made, at their tests' bars; the
    natural 240x320 one beyond 8 px of the border (whole frame logged)."""
    from pathlib import Path

    import numpy as np
    import torch

    from video_classification_tpu_torch.ops.flow import FlowParams, video_flow_uint8

    goldens = Path(__file__).resolve().parent / "tests" / "goldens"
    small = dict(n_outer=2, n_sor=10, min_width=16)
    out = {}
    for name, frames, params, tol, frac, margin in (
            ("flow_240x320", make_frames(), {}, 1, 0.999, 0),
            ("flow_natural_96x128", make_natural_frames(h=96, w=128), small, 1, 0.999, 0),
            ("flow_natural_240x320", make_natural_frames(), {}, 2, 0.995, 8)):
        want = np.load(goldens / f"{name}.npz")["flow_images"].astype(np.int32)
        t0 = time.perf_counter()
        got = video_flow_uint8(torch.from_numpy(frames).to(dev),
                               FlowParams(fuse_level="off", **params))
        got = got.cpu().numpy().astype(np.int32)
        secs = time.perf_counter() - t0
        ok = np.abs(got - want) <= tol
        h, w = got.shape[1:3]
        yy, xx = np.mgrid[0:h, 0:w]
        inner = np.minimum(np.minimum(yy, h - 1 - yy), np.minimum(xx, w - 1 - xx)) >= margin
        whole, gated = float(ok.mean()), float(ok[:, inner].mean())
        log(f"  {name}: within +-{tol} {gated:.6f} beyond {margin} px of the border, "
            f"{whole:.6f} whole frame (bar {frac}); {secs:.2f} s")
        if gated < frac:
            raise AssertionError(f"{name}: {gated} < {frac}")
        out[name] = {"within": gated, "whole_frame": whole}
    # The natural 240x320 golden on both paths, within +-1 and +-2, over the
    # whole frame and beyond 8 px of the border.
    for path, params in (("per-op", FlowParams(fuse_level="off")), ("fused", FlowParams())):
        got = video_flow_uint8(torch.from_numpy(make_natural_frames()).to(dev), params)
        diff = np.abs(got.cpu().numpy().astype(np.int32) - want)
        row = {f"pm{t}_{where}": round(float((d <= t).mean()), 6) for t in (1, 2)
               for where, d in (("whole", diff), ("inner8", diff[:, inner]))}
        log(f"  flow_natural_240x320, {path} path: {json.dumps(row)}")
        out[f"flow_natural_240x320_{path}"] = row
    return out


def synthetic_videos(n: int = 3):
    """n 130-frame 240x320 coherent-motion videos (rgb, depth) as numpy."""
    from video_classification_tpu_torch.profile_train import synthetic_video

    return [synthetic_video(10 + r) for r in range(n)]


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


def serve_full_width(dev, root: str, videos, kernels, detector=None,
                     flow_params=None, absent=(), name="slowfast-HTAH", clips=2):
    """Three requests through Predictor.predict_frames of the stream
    ``name`` (each giving ``clips`` clip windows); ``kernels`` (which must
    launch) and ``absent`` (which must not) are the wrappers whose launch
    counts are zeroed just before and read just after. Returns (counts of
    both, latencies, the detections the detector gave)."""
    import numpy as np

    from video_classification_tpu_torch.config import load_model_cfg
    from video_classification_tpu_torch.engine import Predictor
    from video_classification_tpu_torch.utils.profiling import StageTimer

    cfg = load_model_cfg(name, ["CHALEARN.ROOT", root])
    timer = StageTimer(dev)
    seen = []

    def recording(frames):
        dets = detector(frames)
        seen.append(dets)
        return dets

    t0 = time.perf_counter()
    pred = Predictor(cfg, device=dev, timer=timer, flow_params=flow_params,
                     detector=None if detector is None else recording)
    log(f"  model: depth {cfg.MODEL.DEPTH}, {cfg.CHALEARN.NUM_CLASS} classes, "
        f"{pred.mm.crop_size} px, CLIP_LEN {cfg.CHALEARN.CLIP_LEN}, "
        f"{cfg.CUDA.COMPUTE_DTYPE}; built in {time.perf_counter() - t0:.2f} s")

    for k in (*kernels, *absent):
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
        if y["clips"] != clips:
            raise AssertionError(f"request {r}: {y['clips']} clip windows, expected {clips}")
        log(f"  request {r}: {y['clips']} clips, {latencies[-1]:.3f} s, top-5 "
            + ", ".join(f"{c}:{p:.4f}" for c, p in y["top"]))
        log(f"    stage seconds: {json.dumps({k: round(v, 4) for k, v in timer.seconds.items()})}")
        timer.seconds.clear()
    counts = {k.__name__: k.launches for k in (*kernels, *absent)}
    log(f"  launches on the serving path: {json.dumps(counts)}")
    for k in kernels:
        if counts[k.__name__] == 0:
            raise AssertionError(f"serving path never launched {k.__name__}")
    for k in absent:
        if counts[k.__name__] != 0:
            raise AssertionError(f"serving path launched {k.__name__}")
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


def serve_small_against_cpu(dev, root: str, **flow):
    """The synthetic-detector serving code at a small size on the card and
    on the CPU; ``flow`` overrides the configuration's flow parameters."""
    import torch

    from video_classification_tpu_torch.config import load_model_cfg
    from video_classification_tpu_torch.engine import Predictor
    from video_classification_tpu_torch.pipeline.online import flow_params_from_cfg
    from video_classification_tpu_torch.utils.synthetic import coherent_motion_frames

    cfg = load_model_cfg("slowfast-LHand", [
        "CHALEARN.ROOT", root, "MODEL.DEPTH", "18", "CHALEARN.CLIP_LEN", "2",
        "CHALEARN.NUM_CLASS", "5", "CUDA.COMPUTE_DTYPE", "float32"])
    fp = flow_params_from_cfg(cfg)._replace(**flow)
    rgb = coherent_motion_frames(34, 64, 96, torch.Generator().manual_seed(3)).numpy()
    gpu = Predictor(cfg, device=dev, flow_params=fp)
    cpu = Predictor(cfg, device="cpu", flow_params=fp, state_dict=gpu.model.state_dict())
    clips = []
    for p in (gpu, cpu):
        clips.append(torch.stack(p.dataset(videos={0: (rgb, None)})
                                 .get_eval_clips(0, random.Random(0))["clips"]).cpu())
    frac = within(clips[0], clips[1], 1)
    sg, sc = gpu.clip_scores_frames(rgb), cpu.clip_scores_frames(rgb)
    err = float(abs(sg - sc).max())
    log(f"  small serve card vs cpu ({json.dumps(flow) if flow else 'configured flow'}): "
        f"{clips[0].shape[0]} clips, uint8 within +-1 {frac:.6f}, max|dscore| {err:.3e}")
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


# -- the train/eval slice ---------------------------------------------------------


def gradient_gaps(got, want, exact):
    """(relative L2 over all tensors, worst per-tensor relative L2, worst
    cosine, the bars) of the gradients ``got`` against ``want``, each a
    {name: array}. The bars come from float32's resolution for this network,
    measured: ``exact`` is ``want``'s computation in float64, and two float32
    implementations may each sit as far from it as ``want`` does. Over all
    tensors max(1e-3, 2 x want's distance), per tensor max(1e-3, 2 x the
    largest per-tensor distance), cosine >= 0.999."""
    import numpy as np

    keys = sorted(want)

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    def flat(d):
        return np.concatenate([np.asarray(d[k], np.float64).ravel() for k in keys])

    worst = max(rel(got[k], want[k]) for k in keys)
    cos = min(float(np.dot(got[k].ravel(), want[k].ravel())
                    / (np.linalg.norm(got[k]) * np.linalg.norm(want[k]))) for k in keys)
    bars = (max(1e-3, 2 * rel(flat(want), flat(exact))),
            max(1e-3, 2 * max(rel(want[k], exact[k]) for k in keys)))
    return rel(flat(got), flat(want)), worst, cos, bars


def train_full_width(dev, root: str):
    """[16] slowfast-HTAH trained at full width on synthetic clips through
    Trainer: 3 warm-up and 20 timed train_steps on one repeated batch (the
    largest of 16, 8, 4 that fits), then Trainer.train() for one epoch over
    32 videos with its eval and checkpoint saves. Returns (the trainer, the
    seconds per step, the batch)."""
    import numpy as np
    import torch

    from video_classification_tpu_torch.data.dataset import train_batches
    from video_classification_tpu_torch.engine import Trainer
    from video_classification_tpu_torch.profile_train import train_cfg

    for batch in (16, 8, 4):
        cfg = train_cfg(root, batch, synthetic_videos=32, debug=False)
        cfg.MODEL.MAX_EPOCH = 1
        trainer = Trainer(cfg, device=dev)
        b = next(train_batches(trainer.train_dataset, batch, seed=0))
        x = torch.from_numpy(b["x"]).to(dev)
        labels = torch.from_numpy(b["label"]).to(dev)
        torch.cuda.reset_peak_memory_stats()
        try:
            losses = [trainer.train_step(x, labels)["loss"] for _ in range(3)]
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError:
            log(f"  batch {batch} does not fit in device memory; halving it")
            del trainer, x, labels
            torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for _ in range(20):
        losses.append(trainer.train_step(x, labels)["loss"])
    losses = torch.stack(losses).tolist()  # synchronises through the loss
    step_s = (time.perf_counter() - t0) / 20
    peak = torch.cuda.max_memory_allocated()
    log(f"  model: depth {cfg.MODEL.DEPTH}, {cfg.CHALEARN.NUM_CLASS} classes, "
        f"{trainer.mm.crop_size} px, CLIP_LEN {cfg.CHALEARN.CLIP_LEN}, "
        f"{cfg.CUDA.COMPUTE_DTYPE} compute, {cfg.CUDA.PARAM_DTYPE} master weights; "
        f"batch {batch}")
    log(f"  train step: {step_s * 1e3:.3f} ms, {batch / step_s:.3f} clips/s, peak memory "
        f"{peak / 2**30:.3f} GiB; loss {losses[0]:.4f} at the first step, "
        f"{losses[10]:.4f} after 10, {losses[-1]:.4f} after 22")
    if not np.isfinite(losses).all() or not losses[10] < losses[0]:
        raise AssertionError(f"the loss did not fall on a repeated batch: {losses}")
    t0 = time.perf_counter()
    best = trainer.train()
    saved = sorted(p.name for p in trainer_ckpts(cfg))
    log(f"  Trainer.train(): one epoch of {len(trainer.train_dataset)} videos, eval of "
        f"{len(trainer.test_dataset)}, best acc {best:.4f}, saved {saved}; "
        f"{time.perf_counter() - t0:.2f} s")
    if not saved:
        raise AssertionError("Trainer.train() saved no checkpoint")
    return trainer, step_s, batch


def trainer_ckpts(cfg):
    from video_classification_tpu_torch.engine import ckpt_dir

    return list(ckpt_dir(cfg).glob("*.ckpt"))


def checkpoint_round_trip(dev, trainer, root: str):
    """[17] a fresh Trainer restores the saved checkpoint through tier 1,
    equal state_dicts; tier 3 from a synthesized pytorchvideo-grammar pickle:
    kept keys equal to the file, mismatched ones untouched."""
    import pickle
    from pathlib import Path

    import numpy as np
    import torch

    from video_classification_tpu_torch.engine import Trainer, load_torch_warmstart
    from video_classification_tpu_torch.engine.checkpoint import MISMATCH_LAYERS

    fresh = Trainer(trainer.cfg, device=dev)
    want = trainer.model.state_dict()
    got = fresh.model.state_dict()
    if set(got) != set(want) or not all(torch.equal(got[k], want[k]) for k in want):
        raise AssertionError("tier 1 restored other weights than were saved")
    rng = np.random.RandomState(5)
    sd = {k: rng.normal(size=tuple(v.shape)).astype(np.float32) for k, v in want.items()}
    sd["blocks.6.proj.weight"] = np.ones((400, want["blocks.6.proj.weight"].shape[1]), np.float32)
    sd["blocks.6.proj.bias"] = np.ones((400,), np.float32)
    for k in MISMATCH_LAYERS[:2]:  # the stems of a 3-channel Kinetics input
        sd[k] = np.ones((sd[k].shape[0], 3) + sd[k].shape[2:], np.float32)
    sd["blocks.0.multipathway_blocks.0.norm.num_batches_tracked"] = np.asarray(3)
    path = Path(root) / "kinetics_synth.pyth"
    path.write_bytes(pickle.dumps({"model_state": sd}))
    before = {k: v.clone() for k, v in fresh.model.state_dict().items()}
    kept = load_torch_warmstart(path, fresh.model)
    after = fresh.model.state_dict()
    for k, v in after.items():
        ok = (torch.equal(v.cpu(), torch.from_numpy(sd[k])) if k in kept
              else torch.equal(v, before[k]))
        if not ok:
            raise AssertionError(f"tier 3: {k} {'not loaded' if k in kept else 'changed'}")
    log(f"  tier 1: {len(want)} tensors equal after a fresh Trainer restored "
        f"{sorted(p.name for p in trainer_ckpts(trainer.cfg))[-1]}; tier 3: {len(kept)} "
        f"keys loaded, {len(after) - len(kept)} mismatched left at init")


def train_online(dev, root: str, videos, kernels, absent):
    """[18] Trainer with the online backend at full width (synthetic
    detector, default flow): four labelled 130-frame 240x320 training videos
    and two test videos through dataset_factory; train_epoch(0) in DEBUG
    (one batch of 4), then run_eval(). Returns the launches of the train
    epoch (one step)."""
    import numpy as np

    from video_classification_tpu_torch.engine import Trainer
    from video_classification_tpu_torch.profile_train import online_factory, train_cfg
    from video_classification_tpu_torch.utils.profiling import StageTimer

    cfg = train_cfg(root, 4)
    timer = StageTimer(dev)
    factory = online_factory({"train": videos[:4], "test": videos[4:6]},
                             int(cfg.CHALEARN.NUM_CLASS), dev, timer)
    trainer = Trainer(cfg, device=dev, dataset_factory=factory)
    every = (*kernels, *absent)
    for k in every:
        k.launches = 0
    t0 = time.perf_counter()
    metrics = trainer.train_epoch(0)
    epoch_s = time.perf_counter() - t0
    train_counts = {k.__name__: k.launches for k in every}
    making = dict(timer.seconds)
    for k in every:
        k.launches = 0
    t0 = time.perf_counter()
    y = trainer.run_eval()
    eval_s = time.perf_counter() - t0
    eval_counts = {k.__name__: k.launches for k in every}
    make_s = sum(making.values())
    log(f"  train_epoch(0): loss {metrics['loss']:.4f}, {epoch_s:.3f} s, of which making "
        f"the 4 clips {make_s:.3f} s (stages {json.dumps({k: round(v, 4) for k, v in making.items()})}) "
        f"and the step {epoch_s - make_s:.3f} s")
    log(f"  launches in the train epoch (one step): {json.dumps(train_counts)}; "
        f"in run_eval: {json.dumps(eval_counts)}")
    log(f"  run_eval: {eval_s:.3f} s, ps {y['ps'].shape}, t {y['t'].tolist()}, "
        f"sv {y['sv']}, acc {y['acc']:.4f}")
    for counts, what in ((train_counts, "train epoch"), (eval_counts, "eval")):
        for k in kernels:
            if counts[k.__name__] == 0:
                raise AssertionError(f"the online {what} never launched {k.__name__}")
        for k in absent:
            if counts[k.__name__] != 0:
                raise AssertionError(f"the online {what} launched {k.__name__}")
    if (not np.isfinite(metrics["loss"]) or y["sv"] != [2, 2] or y["ps"].shape != (4, 249)
            or not np.allclose(y["ps"].sum(1), 1.0, atol=1e-4)):
        raise AssertionError(f"online train/eval gave {metrics}, {y['ps'].shape}, {y['sv']}")
    return train_counts


def no_dropout(model) -> None:
    """Head dropout rate 0 (SlowFast's and Res3D's heads; res2d has none)."""
    from video_classification_tpu_torch.models.slowfast import ResNetBasicHead

    for m in model.modules():
        if isinstance(m, ResNetBasicHead):
            m.dropout_rate = 0.0


def train_small_against_cpu(dev, root: str, name: str = "slowfast-small-train",
                            card_spread: bool = False):
    """[19], [25] one train step and the eval of the model ``name``
    (MODEL.NAME) at depth 18, CLIP_LEN 4, CropLHand, float32 (TF32 off),
    dropout 0, on the card and on the CPU from the same weights, batch and
    crop offsets: loss within 1e-4 relative, gradients at the bars of
    gradient_gaps (against the CPU step in float64), running statistics and
    eval scores within 5e-3.

    With ``card_spread`` ([25]) the card's float64 step must give the CPU's
    float64 gradient within 1e-6 (the same function), and the gradient bars
    also admit twice the card's own float32 spread: its gradient with the
    batch rows permuted, as tests/test_torch_port_trainer.py measures the
    JAX package's. The CPU's float32 gradient can sit far closer to the
    float64 one than float32 resolves on the card, whose convolutions sum in
    other orders (BatchNorm's E[x^2] - E[x]^2 over few values amplifies such
    differences); the phase prints the spread and the float64 gap beside the
    bars."""
    import torch

    from video_classification_tpu_torch.config import get_cfg
    from video_classification_tpu_torch.data.dataset import train_batches
    from video_classification_tpu_torch.engine import Trainer

    cfg = get_cfg()
    cfg.CHALEARN.ROOT = root
    cfg.CHALEARN.NUM_CLASS = 3
    cfg.CHALEARN.CLIP_LEN = 4
    cfg.CHALEARN.BATCH_SIZE = 4
    cfg.MODEL.NAME = name
    cfg.MODEL.R3D_INPUT = "CropLHand"
    cfg.MODEL.DEPTH = 18
    cfg.CUDA.COMPUTE_DTYPE = "float32"
    cfg.DATA.SYNTHETIC_NUM_VIDEOS = 8
    cfg.DATA.SYNTHETIC_SEQ_LEN = 6
    cfg.DEBUG = True
    step_card_vs_cpu(dev, name, lambda c, d: Trainer(c, device=d), cfg,
                     lambda t: next(train_batches(t.train_dataset, 4, seed=0)),
                     torch.tensor([[0, 3], [12, 5], [6, 6], [1, 11]]), card_spread)


def step_card_vs_cpu(dev, name, make, cfg, make_batch, offsets, card_spread=False):
    """One train step and the eval of trainers ``make(cfg, device)`` on the
    card and on the CPU from the same weights, batch (``make_batch`` of the
    CPU trainer) and crop offsets, float32 (TF32 off), dropout 0: loss within
    1e-4 relative, gradients at the bars of gradient_gaps (against the CPU
    step in float64), running statistics and eval scores within 5e-3.
    ``card_spread``: see train_small_against_cpu (a batch of 4)."""
    import numpy as np
    import torch

    f64 = cfg.clone()
    f64.CUDA.COMPUTE_DTYPE = f64.CUDA.PARAM_DTYPE = "float64"
    trainers = [make(cfg, dev), make(cfg, "cpu"), make(f64, "cpu")]
    if card_spread:  # the card's float32 step on permuted rows, its float64 step
        trainers += [make(cfg, dev), make(f64, dev)]
    state = {k: v.cpu() for k, v in trainers[0].model.state_dict().items()}
    for t in trainers:
        t.model.load_state_dict(state)
        no_dropout(t.model)
    b = make_batch(trainers[1])
    x, labels = torch.from_numpy(b["x"]), torch.from_numpy(b["label"])
    gpu = trainers[0].train_step(x.to(dev), labels.to(dev), offsets=offsets.to(dev))
    cpu = trainers[1].train_step(x, labels, offsets=offsets)
    trainers[2].train_step(x, labels, offsets=offsets)
    if card_spread:
        rows = torch.tensor([2, 0, 3, 1])
        trainers[3].train_step(x[rows].to(dev), labels[rows].to(dev),
                               offsets=offsets[rows].to(dev))
        trainers[4].train_step(x.to(dev), labels.to(dev), offsets=offsets.to(dev))
    grads = [{k: p.grad.double().cpu().numpy() for k, p in t.model.named_parameters()}
             for t in trainers]
    loss_err = abs(float(gpu["loss"]) - float(cpu["loss"])) / abs(float(cpu["loss"]))
    whole, worst, cos, bars = gradient_gaps(grads[0], grads[1], grads[2])
    if card_spread:
        spread_all, spread_each = gradient_gaps(grads[3], grads[0], grads[2])[:2]
        f64_err = gradient_gaps(grads[4], grads[2], grads[2])[0]
        log(f"  {name}: the card's float64 gradient {f64_err:.2e} from the CPU's; its float32 "
            f"gradient moves by {spread_all:.2e} over all, {spread_each:.2e} worst tensor, "
            f"with the batch rows permuted")
        if f64_err > 1e-6:
            raise AssertionError(f"{name}: the card's float64 step differs from the CPU's")
        bars = (max(bars[0], 2 * spread_all), max(bars[1], 2 * spread_each))
    stats = max(float(((a.cpu() - b) / (5e-3 + 5e-3 * b.abs())).abs().max())
                for (n, a), b in zip(trainers[0].model.state_dict().items(),
                                     trainers[1].model.state_dict().values())
                if "running_" in n)
    ps = [t.run_eval()["ps"] for t in trainers[:2]]
    score_err = float(np.abs(ps[0] - ps[1]).max())
    log(f"  small {name} train step card vs cpu: loss {float(gpu['loss']):.6f} vs "
        f"{float(cpu['loss']):.6f} (rel {loss_err:.2e}); gradients rel L2 {whole:.2e} over "
        f"all (bar {bars[0]:.2e}), worst tensor {worst:.2e} (bar {bars[1]:.2e}), min cosine "
        f"{cos:.6f}; running stats at {stats:.3f} of the 5e-3 bar; max|dscore| {score_err:.2e}")
    if (loss_err > 1e-4 or whole > bars[0] or worst > bars[1] or cos < 0.999
            or stats > 1.0 or score_err > SCORE_ATOL):
        raise AssertionError(f"the small {name} train step disagrees between card and cpu")


BINDING_CHILD = """
import sys
import torch
from video_classification_tpu_torch.utils.cuda import build
ext, d = build(), torch.device("cuda")
z = torch.zeros((2, 8, 8), device=d)
im = torch.zeros((2, 8, 8, 3), device=d)
calls = {
    "flow_level": lambda: ext.flow_level(im, im, z, z, 1, 1, 0.012, 1.8, 1e-6, 8, 0.0, [0, 0, 0]),
    "sor_solve": lambda: ext.sor_solve(*([z] * 13), 1, 0.012, 1.8, [0, 0, 0]),
    "component_extents": lambda: ext.component_extents(
        torch.zeros((1, 65535, 1), dtype=torch.bool, device=d), 8),
    "nms": lambda: ext.nms(torch.zeros((1, 20000, 4), device=d),
                           torch.zeros((1, 19999), device=d), 4, 0.5),
    "warp_bilinear": lambda: ext.warp_bilinear(im, z[:, :4], z),
    "label_components": lambda: ext.label_components(torch.zeros((8, 8), device=d), 8),
}
try:
    calls[sys.argv[1]]()
    torch.cuda.synchronize()
except Exception as e:
    print(f"RAISED {type(e).__name__}: {str(e).splitlines()[0]}")
"""


def binding_errors():
    """[20] each of the six bindings gets one malformed input that only the
    binding's own checks refuse (the SOR schedule, a 65535-row mask,
    mismatched shapes), in a child process of its own: the child
    must print the Python exception and exit 0; one ended by a signal fails
    the phase."""
    from pathlib import Path

    root = Path(__file__).resolve().parent
    names = ("flow_level", "sor_solve", "component_extents", "nms", "warp_bilinear",
             "label_components")
    children = {n: subprocess.Popen([sys.executable, "-c", BINDING_CHILD, n], cwd=root,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for n in names}
    failed = []
    for n, child in children.items():
        try:
            out, err = child.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            child.kill()
            out, err = child.communicate()
        said = [line for line in out.splitlines() if line.startswith("RAISED")]
        how = f"signal {-child.returncode}" if child.returncode < 0 else f"exit {child.returncode}"
        log(f"  {n}: {how}, {said[0] if said else 'no exception: ' + err.strip()[-300:]}")
        if child.returncode != 0 or not said:
            failed.append(n)
    if failed:
        raise AssertionError(f"bindings without a Python exception: {failed}")


# -- the ensemble slice: sparse fusion, the res models, the CLI --------------------


def fusion_ckpts(root: str):
    """The fusion checkpoints under ``root``, sorted."""
    from video_classification_tpu_torch.config import get_cfg
    from video_classification_tpu_torch.engine.sparse import fusion_ckpt_dir

    cfg = get_cfg()
    cfg.CHALEARN.ROOT = root
    d = fusion_ckpt_dir(cfg)
    return sorted(d.iterdir()) if d.is_dir() else []


def ensemble_full_width(dev, root: str, videos, kernels, absent, serving_counts):
    """[21] the five part streams at full width (SlowFast-R50, 249 classes,
    CLIP_LEN 20, bf16, seeded random weights; CropHTAH 192, the arms 128,
    the hands 64): ResultSaver dumps train and test materials through each
    stream's Trainer from synthetic datasets of 8 videos, SparseTrainer
    trains the fusion for 20 epochs (on, to SPARSE_EPOCHS, if no test
    improved on accuracy 0: the streams' random weights carry little
    signal) and checkpoints, and EnsemblePredictor loads that checkpoint and
    serves the three videos through predict_frames. ``kernels`` must launch
    exactly 5x their ``serving_counts`` of [6] (the same three videos, one
    stream), ``absent`` not at all. Returns (counts, latencies)."""
    import numpy as np

    from video_classification_tpu_torch.config import load_model_cfg
    from video_classification_tpu_torch.engine import (EnsemblePredictor, ResultSaver,
                                                       SparseTrainer)
    from video_classification_tpu_torch.engine.sparse import PART_YAMLS, SPARSE_EPOCHS
    from video_classification_tpu_torch.utils.profiling import StageTimer

    overrides = ["CHALEARN.ROOT", root, "DATA.SYNTHETIC_NUM_VIDEOS", "8"]
    t0 = time.perf_counter()
    written = ResultSaver(cfg_overrides=overrides, device=dev).save_network_output()
    log(f"  ResultSaver: {len(written)} materials of the {len(PART_YAMLS)} streams in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    st = SparseTrainer(load_model_cfg("slowfast-HTAH", overrides), device=dev)
    ds = st.train_dataset
    if ((ds.num_part, ds.num_class, len(ds.sv), int(ds.sv.sum())) != (5, 249, 8, ds.num_n)
            or ds.part_names != sorted(PART_YAMLS)):
        raise AssertionError(f"materials {ds.PS.shape} of {ds.part_names}, sv {ds.sv}")
    epochs = 20
    best = st.train(epochs=epochs)
    if not fusion_ckpts(root):
        log(f"  no fusion checkpoint after {epochs} epochs (best accuracy {best}); "
            f"training on to {SPARSE_EPOCHS}")
        best = st.train(epochs=SPARSE_EPOCHS - epochs)
        epochs = SPARSE_EPOCHS
    ckpts = fusion_ckpts(root)
    log(f"  SparseTrainer: {epochs} epochs, best accuracy {best:.4f}, checkpoints "
        f"{[c.name for c in ckpts]}; {time.perf_counter() - t0:.2f} s")
    if not ckpts:
        raise AssertionError("SparseTrainer wrote no fusion checkpoint")
    del st

    t0 = time.perf_counter()
    ens = EnsemblePredictor(cfg_overrides=["CHALEARN.ROOT", root], device=dev)
    for p in ens.predictors:
        p.timer = StageTimer(dev)
    log(f"  EnsemblePredictor: streams {ens.part_yamls}, crops "
        f"{[p.mm.crop_size for p in ens.predictors]}; built in {time.perf_counter() - t0:.2f} s")
    for k in (*kernels, *absent):
        k.launches = 0
    latencies = []
    for r, (rgb, depth) in enumerate(videos):
        t0 = time.perf_counter()
        y = ens.predict_frames(rgb, depth, top_k=5)
        latencies.append(time.perf_counter() - t0)
        probs = y["probs"]
        if (probs.shape != (249,) or not np.isfinite(probs).all()
                or abs(float(probs.sum()) - 1.0) > 1e-4):
            raise AssertionError(f"request {r}: bad probabilities {probs.shape}, "
                                 f"sum {probs.sum()}")
        if y["clips"] != 2 or list(y["per_stream"]) != sorted(PART_YAMLS):
            raise AssertionError(f"request {r}: {y['clips']} clips, {list(y['per_stream'])}")
        log(f"  request {r}: {latencies[-1]:.3f} s, top-5 "
            + ", ".join(f"{c}:{p:.4f}" for c, p in y["top"]))
        for name, p in zip(ens.part_yamls, ens.predictors):
            log(f"    {name} stage seconds: "
                f"{json.dumps({k: round(v, 4) for k, v in p.timer.seconds.items()})}")
            p.timer.seconds.clear()
    if ens.fusion_source != str(ckpts[-1]):
        raise AssertionError(f"the ensemble fused with {ens.fusion_source}, not {ckpts[-1]}")
    counts = {k.__name__: k.launches for k in (*kernels, *absent)}
    log(f"  launches on the ensemble path ({len(videos)} requests): {json.dumps(counts)}; "
        f"the fusion from {ens.fusion_source}")
    for k in kernels:
        if counts[k.__name__] != 5 * serving_counts[k.__name__]:
            raise AssertionError(f"{k.__name__}: {counts[k.__name__]} launches, expected 5 x "
                                 f"{serving_counts[k.__name__]} of one stream")
    for k in absent:
        if counts[k.__name__] != 0:
            raise AssertionError(f"the ensemble launched {k.__name__}")
    return counts, latencies


def ensemble_small_against_cpu(dev, root: str):
    """[22] the five-stream ensemble at depth 18, CLIP_LEN 2, 5 classes,
    float32 on the card and on the CPU with the same stream weights and
    fusion parameters, on a 34-frame 64x96 video: fused probs within 5e-3,
    the same top-1, clips and per-stream scores."""
    import numpy as np
    import torch

    from video_classification_tpu_torch.engine import EnsemblePredictor
    from video_classification_tpu_torch.utils.synthetic import coherent_motion_frames

    overrides = ["CHALEARN.ROOT", root, "MODEL.DEPTH", "18", "CHALEARN.CLIP_LEN", "2",
                 "CHALEARN.NUM_CLASS", "5", "CUDA.COMPUTE_DTYPE", "float32"]
    rng = np.random.RandomState(4)
    fusion = {"weight": rng.normal(1.0, 0.5, (5, 5)).astype(np.float32),
              "bias": rng.normal(0.0, 0.2, (5,)).astype(np.float32)}
    gpu = EnsemblePredictor(cfg_overrides=overrides, device=dev, fusion_params=fusion)
    cpu = EnsemblePredictor(cfg_overrides=overrides, device="cpu", fusion_params=fusion)
    for g, c in zip(gpu.predictors, cpu.predictors):
        c.model.load_state_dict(g.model.state_dict())
    rgb = coherent_motion_frames(34, 64, 96, torch.Generator().manual_seed(3)).numpy()
    yg, yc = gpu.predict_frames(rgb), cpu.predict_frames(rgb)
    err = float(np.abs(yg["probs"] - yc["probs"]).max())
    stream_err = max(abs(yg["per_stream"][n] - yc["per_stream"][n]) for n in yc["per_stream"])
    log(f"  small ensemble card vs cpu: {yg['clips']} clips, max|dprob| {err:.3e}, "
        f"max|dper_stream| {stream_err:.3e}, top-1 {yg['top'][0][0]} vs {yc['top'][0][0]}")
    if (err > SCORE_ATOL or stream_err > SCORE_ATOL or yg["clips"] != yc["clips"]
            or yg["top"][0][0] != yc["top"][0][0]):
        raise AssertionError("the small ensemble disagrees between card and cpu")


def sparse_full_size(dev, root: str):
    """[23] SparseTrainer at full size: P 5, C 249, 35,878 train and 6,271
    test clips (IsoGD's split sizes, one clip per video), synthesized
    materials; batch 500. One warm-up epoch, then 20 timed epochs (host
    clock, synchronised through the losses), test() (after a first call
    that may checkpoint), peak device memory, and the seconds projected for
    SPARSE_EPOCHS epochs with a test every TEST_EVERY."""
    import pickle

    import numpy as np
    import torch

    from video_classification_tpu_torch.config import load_model_cfg
    from video_classification_tpu_torch.engine import SparseTrainer
    from video_classification_tpu_torch.engine.sparse import (PART_YAMLS, SPARSE_EPOCHS,
                                                              TEST_EVERY, sparse_dir)

    cfg = load_model_cfg("slowfast-HTAH", ["CHALEARN.ROOT", root])
    rng = np.random.default_rng(6)
    t0 = time.perf_counter()
    for name_of_set, n in (("train", 35878), ("test", 6271)):
        t = rng.integers(0, 249, n).astype(np.int32)
        d = sparse_dir(cfg, name_of_set)
        d.mkdir(parents=True, exist_ok=True)
        for name in PART_YAMLS:
            logits = rng.standard_normal((n, 249), dtype=np.float32)
            logits[np.arange(n), t] += 1.0
            ps = np.exp(logits)
            ps /= ps.sum(1, keepdims=True)
            with (d / name).open("wb") as f:
                pickle.dump({"ps": ps, "t": t, "acc": 0.0, "sv": [1] * n}, f)
    made = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st = SparseTrainer(cfg, device=dev)
    load_s = time.perf_counter() - t0
    st.train_epoch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = torch.stack([st.train_epoch() for _ in range(20)]).tolist()
    epoch_ms = (time.perf_counter() - t0) / 20 * 1e3
    st.test(20)
    t0 = time.perf_counter()
    acc = st.test(21)
    test_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    projected = (SPARSE_EPOCHS * epoch_ms + SPARSE_EPOCHS // TEST_EVERY * test_ms) / 1e3
    n = st.x_train.shape[0]
    log(f"  materials {tuple(st.x_train.shape)} train, {tuple(st.x_test.shape)} test "
        f"({(st.x_train.numel() + st.x_test.numel()) * 4 / 1e6:.1f} MB; written in "
        f"{made:.2f} s, loaded in {load_s:.2f} s); {-(-n // st.batch_size)} Adam steps per epoch")
    log(f"  {epoch_ms:.3f} ms per epoch, test() {test_ms:.3f} ms, peak memory "
        f"{peak / 2**20:.1f} MiB; {SPARSE_EPOCHS} epochs projected {projected:.2f} s; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, test accuracy {acc:.4f}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"the fusion loss did not fall: {losses}")
    return epoch_ms, test_ms, projected


def train_res_full_width(dev, root: str, name: str, videos, kernels, absent):
    """[24] the res model ``name`` (its yaml: res3d batch 30, CLIP_LEN 20;
    res2d batch 60, CLIP_LEN 10, a 50-channel stem; CropHTAH 192, 249
    classes, bf16 compute) trained at full width on synthetic clips: 3
    warm-up and 20 timed train_steps on one batch (ms, clips/s, peak
    memory, the loss finite and lower after 10 steps than at the first),
    then served through Predictor.predict_frames on the three videos (K1
    and K2 launch, ``absent`` do not). Returns (seconds per step, batch,
    peak bytes, serving counts, latencies)."""
    import numpy as np
    import torch

    from video_classification_tpu_torch.config import load_model_cfg
    from video_classification_tpu_torch.data.dataset import train_batches
    from video_classification_tpu_torch.engine import Trainer
    from video_classification_tpu_torch.ops.sampling import num_uniform_clips

    cfg = load_model_cfg(name, ["CHALEARN.ROOT", root])
    batch = int(cfg.CHALEARN.BATCH_SIZE)
    cfg.DATA.SYNTHETIC_NUM_VIDEOS = batch
    cfg.DATA.SYNTHETIC_SEQ_LEN = 24
    cfg.DEBUG = True  # no checkpoint: the serving below keeps the seeded weights
    trainer = Trainer(cfg, device=dev)
    b = next(train_batches(trainer.train_dataset, batch, seed=0))
    x = torch.from_numpy(b["x"]).to(dev)
    labels = torch.from_numpy(b["label"]).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [trainer.train_step(x, labels)["loss"] for _ in range(3)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        losses.append(trainer.train_step(x, labels)["loss"])
    losses = torch.stack(losses).tolist()
    step_s = (time.perf_counter() - t0) / 20
    peak = torch.cuda.max_memory_allocated()
    log(f"  {name}: depth {cfg.MODEL.DEPTH}, {cfg.CHALEARN.NUM_CLASS} classes, "
        f"{trainer.mm.crop_size} px, CLIP_LEN {cfg.CHALEARN.CLIP_LEN}, input "
        f"{tuple(trainer.mm.normalize_and_prepare(x[:1]).shape[1:])}, "
        f"{cfg.CUDA.COMPUTE_DTYPE} compute; batch {batch}")
    log(f"  train step: {step_s * 1e3:.3f} ms, {batch / step_s:.3f} clips/s, peak memory "
        f"{peak / 2**30:.3f} GiB; loss {losses[0]:.4f} at the first step, "
        f"{losses[10]:.4f} after 10, {losses[-1]:.4f} after 22")
    if not np.isfinite(losses).all() or not losses[10] < losses[0]:
        raise AssertionError(f"{name}: the loss did not fall on a repeated batch: {losses}")
    del trainer, x, labels
    torch.cuda.empty_cache()
    clips = num_uniform_clips(-(-videos[0][0].shape[0] // int(cfg.CHALEARN.IMG_SAMPLE_INTERVAL)),
                              int(cfg.CHALEARN.CLIP_LEN))
    counts, latencies, _ = serve_full_width(dev, root, videos, kernels, absent=absent,
                                            name=name, clips=clips)
    return step_s, batch, peak, counts, latencies


def cli_on_card(ensemble_root: str, labels):
    """[26] ``python -m video_classification_tpu_torch`` in a subprocess on
    the card: ``sparse-train`` on [21]'s materials (SPARSE_EPOCHS epochs)
    and ``tools how-many-classes`` on a labels file of ``labels``; both must
    exit 0, the second print the labels' min, max and class count."""
    from pathlib import Path

    here = Path(__file__).resolve().parent
    labels_txt = Path(ensemble_root) / "labels.txt"
    labels_txt.write_text("".join(f"train/M_{i:05d}.avi train/K_{i:05d}.avi {label}\n"
                                  for i, label in enumerate(labels)))
    want = f"{min(labels)} {max(labels)} {len(set(labels))}"
    for args in (["sparse-train", "--root", ensemble_root],
                 ["tools", "how-many-classes", str(labels_txt)]):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "video_classification_tpu_torch", *args],
                             cwd=here, capture_output=True, text=True, timeout=900)
        tail = (out.stdout.strip().splitlines() or [""])[-1]
        log(f"  {' '.join(args[:2])}: exit {out.returncode} in "
            f"{time.perf_counter() - t0:.2f} s; last line: {tail}")
        if out.returncode != 0:
            raise AssertionError(f"the CLI failed: {out.stderr.strip()[-2000:]}")
    if not out.stdout.startswith(want):
        raise AssertionError(f"how-many-classes printed {out.stdout!r}, expected {want!r}")


# -- the offline chain: frame I/O, the stages, the IUV provider -------------------

OFFLINE_SETS = ("train", "test")
CROP_STREAMS = ("CropHTAH", "CropLHand", "CropRHand", "CropLHandArm", "CropRHandArm",
                "CropTorso")


def port_kernels():
    """The six kernel wrappers, K1-K6."""
    from video_classification_tpu_torch.detect.nms import nms
    from video_classification_tpu_torch.ops.component_extents import component_extents
    from video_classification_tpu_torch.ops.flow_level import flow_level
    from video_classification_tpu_torch.ops.label_components import label_components
    from video_classification_tpu_torch.ops.sor_solve import sor_solve
    from video_classification_tpu_torch.ops.warp import warp_bilinear

    return (flow_level, component_extents, nms, sor_solve, warp_bilinear, label_components)


class Recorder:
    """Replaces ``module.name`` (a kernel wrapper as its callers see it) by
    a wrapper that keeps clones of the arguments of up to ``keep`` calls,
    until the ``with`` block ends."""

    def __init__(self, module, name: str, keep: int = 10 ** 9):
        self.module, self.name, self.keep, self.calls = module, name, keep, []

    def __enter__(self):
        import torch

        real = self.real = getattr(self.module, self.name)

        def record(*args, **kwargs):
            if len(self.calls) < self.keep:
                self.calls.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                        for a in args))
            return real(*args, **kwargs)

        setattr(self.module, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def chain_counts(what, run, must, absent):
    """Zero every kernel's launch count just before ``run()``, read them
    just after; each of ``must`` launched, none of ``absent``."""
    kernels = port_kernels()
    for k in kernels:
        k.launches = 0
    run()
    counts = {k.__name__: k.launches for k in kernels}
    log(f"  {what} launches: {json.dumps(counts)}")
    for name in must:
        if counts[name] == 0:
            raise AssertionError(f"{what} never launched {name}")
    for name in absent:
        if counts[name] != 0:
            raise AssertionError(f"{what} launched {name}")
    return counts


def check_extents_calls(what, calls, chunk_pixels=1 << 24):
    """K2 exact on every captured call: the kernel on each call's (B, H, W)
    masks against the plain version on the same masks (calls of one shape
    stacked, up to ``chunk_pixels`` a plain run); the largest call timed
    with its route beside its bound (``time_extents``), returned with the
    count of calls and masks compared."""
    import torch

    from video_classification_tpu_torch.ops.component_extents import (
        component_extents, component_extents_reference)
    from video_classification_tpu_torch.utils.cuda import build

    by_shape = {}
    for (masks,) in calls:
        by_shape.setdefault(tuple(masks.shape[1:]), []).append(masks)
    for (h, w), group in by_shape.items():
        per = max(1, chunk_pixels // (group[0].shape[0] * h * w))
        for i in range(0, len(group), per):
            part = group[i:i + per]
            got = [torch.cat(f) for f in zip(*(component_extents(m) for m in part))]
            want = component_extents_reference(torch.cat(part))
            err = max(int((a.long() - c.long()).abs().max()) for a, c in zip(got, want))
            if err:
                raise AssertionError(f"K2 {what} {h}x{w}: max |kernel - plain| {err}")
    route = build().component_extents_route
    sizes = sorted(by_shape, key=lambda s: s[0] * s[1])
    routes = sorted({route(h, w) for h, w in sizes})
    n_masks = sum(m.shape[0] for (m,) in calls)
    log(f"  K2 {what}: {len(calls)} calls ({n_masks} masks) exact; box sizes {sizes[0]} to "
        f"{sizes[-1]} ({len(sizes)} sizes), {' and '.join(routes)} words")
    largest = max((m for (m,) in calls), key=lambda m: m.numel())
    h, w = largest.shape[1:]
    words = route(h, w)
    row = time_extents(f"{what} {'x'.join(map(str, largest.shape))} part masks", largest,
                       4 if words == "narrow" else 2, words)
    return dict(row, calls=len(calls), masks_compared=n_masks)


def check_resizes_and_io(dev, work):
    """[27] The provider's three resizes on the card against the CPU,
    exactly (480x640 -> 800x1067 in uint8, and box sizes 1x1 to 480x640
    from 112x112 charts, fields and frames), an ArrayFrameIO round trip, and
    Cv2FrameIO refusing where cv2 is absent."""
    from pathlib import Path

    import numpy as np
    import torch

    from video_classification_tpu_torch.ops.image import (resize_linear_f32,
                                                          resize_linear_u8, resize_nearest)
    from video_classification_tpu_torch.pipeline.frame_io import ArrayFrameIO, Cv2FrameIO

    g = torch.Generator().manual_seed(27)
    frames = torch.randint(0, 256, (8, 480, 640, 3), generator=g, dtype=torch.uint8)
    charts = torch.randint(0, 25, (2, 112, 112), generator=g, dtype=torch.int32)
    fields = torch.rand((2, 112, 112), generator=g)
    small = torch.randint(0, 256, (2, 112, 112, 3), generator=g, dtype=torch.uint8)
    cases = [("uint8 linear", resize_linear_u8, frames, (800, 1067))]
    for hw in ((1, 1), (1, 37), (53, 1), (17, 29), (113, 175), (240, 320), (307, 211),
               (480, 640)):
        cases += [("nearest", resize_nearest, charts, hw),
                  ("float32 linear", resize_linear_f32, fields, hw),
                  ("uint8 linear", resize_linear_u8, small, hw)]
    for what, fn, x, hw in cases:
        card, cpu = fn(x.to(dev), hw).cpu(), fn(x, hw)
        if card.dtype != cpu.dtype or not torch.equal(card, cpu):
            raise AssertionError(f"{what} {tuple(x.shape)} -> {hw}: card and cpu differ")
    ms = cuda_ms(lambda: resize_linear_u8(frames.to(dev), (800, 1067)), reps=10)
    log(f"  resizes: {len(cases)} cases equal on the card and the CPU; the provider's "
        f"uint8 resize of 8 x 480x640 -> 800x1067 (with the upload) {ms:.4f} ms")

    io, folder = ArrayFrameIO(), Path(work)
    img = np.random.RandomState(0).randint(0, 256, (240, 320, 3)).astype(np.uint8)
    io.imwrite(folder / "00005.jpg", img)
    io.imwrite(folder / "U_00005.jpg", img[..., 0])
    io.write_video(folder / "M_00001.avi", [img, img[::-1]])
    back = io.read_video(folder / "M_00001.avi")
    if not (np.array_equal(io.imread(folder / "00005.jpg"), img)
            and np.array_equal(io.imread(folder / "U_00005.jpg", gray=True), img[..., 0])
            and len(back) == 2 and np.array_equal(back[1], img[::-1])):
        raise AssertionError("ArrayFrameIO round trip")
    log("  ArrayFrameIO: image, gray image and video round trip exact")
    try:
        import cv2  # noqa: F401
    except ImportError:
        try:
            Cv2FrameIO()
        except ImportError as e:
            if "ArrayFrameIO" not in str(e):
                raise AssertionError(f"Cv2FrameIO's error does not name ArrayFrameIO: {e}")
            log("  Cv2FrameIO() without cv2: ImportError naming ArrayFrameIO")
        else:
            raise AssertionError("Cv2FrameIO() did not raise without cv2")
        return None
    log("  Cv2FrameIO() check skipped: this machine has cv2")
    return resizes_against_cv2(dev, cases, g)


def resizes_against_cv2(dev, cases, g):
    """[27] The port's resizes on the card against this machine's
    cv2.resize, on [27]'s cases and on exact 2x downscales of 3-8 channels
    (OpenCV's area rule past 4 channels). A difference is recorded (the cv2
    version, the cases), not fatal: the rules were found against another
    cv2 build."""
    import cv2
    import numpy as np
    import torch

    from video_classification_tpu_torch.ops.image import resize_linear_u8

    flags = {"uint8 linear": cv2.INTER_LINEAR, "float32 linear": cv2.INTER_LINEAR,
             "nearest": cv2.INTER_NEAREST}
    checks = [(what, fn, x, hw, flags[what]) for what, fn, x, hw in cases]
    for c in (3, 4, 5, 6, 7, 8):
        for hw in ((1, 1), (2, 3), (29, 17), (64, 64), (96, 128)):
            x = torch.randint(0, 256, (2, 2 * hw[0], 2 * hw[1], c), generator=g,
                              dtype=torch.uint8)
            checks.append((f"uint8 exact 2x, {c} channels", resize_linear_u8, x, hw,
                           cv2.INTER_LINEAR))
    differ = []
    for what, fn, x, hw, flag in checks:
        got = fn(x.to(dev), hw).cpu().numpy()
        src = x.numpy()
        if src.dtype == np.int32:  # charts: cv2 resizes uint8 labels
            src = src.astype(np.uint8)
        want = np.stack([cv2.resize(im, (hw[1], hw[0]), interpolation=flag) for im in src])
        want = want.reshape(got.shape).astype(got.dtype)
        if not np.array_equal(got, want):
            diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
            differ.append({"case": what, "from": list(x.shape[1:3]), "to": list(hw),
                           "values_differing": int((diff > 0).sum()),
                           "max_abs_diff": float(diff.max())})
    row = {"cv2": cv2.__version__, "cases": len(checks), "equal": len(checks) - len(differ),
           "differing": differ}
    log(f"  the port's resizes on the card against this machine's cv2: {json.dumps(row)}")
    return row


def offline_chain_full_width(dev, work):
    """[28] The whole chain at full width with the synthetic provider: a
    raw fixture through ArrayFrameIO (one 130-frame 240x320 M_/K_ pair in
    train and one in test), every stage (energy and CSE too), seconds per
    stage, files per stage folder, every crop stream written; K1 and K2
    launch, K3-K6 do not. Returns (root, counts, stage seconds, the K1 calls
    of the first video)."""
    from pathlib import Path

    import video_classification_tpu_torch.ops.flow as flow_mod
    from video_classification_tpu_torch.pipeline import stages
    from video_classification_tpu_torch.pipeline.frame_io import ArrayFrameIO
    from video_classification_tpu_torch.pipeline.iuv_contract import SyntheticIUVProvider
    from video_classification_tpu_torch.profile_preprocess import (FRAMES, chain_cfg,
                                                                   stage_files, write_fixture)
    from video_classification_tpu_torch.utils.profiling import StageTimer

    root, io = Path(work) / "chain", ArrayFrameIO()
    t0 = time.perf_counter()
    write_fixture(root, io)
    log(f"  fixture: 2 M_/K_ pairs of {FRAMES} 240x320 frames in "
        f"{time.perf_counter() - t0:.2f} s")
    timer = StageTimer(dev)
    # Chunks of 64 pairs (130 frames: 64, 65 and 1) x nine pyramid levels.
    k1_per_video = len(range(0, FRAMES, 64)) * 9
    with Recorder(flow_mod, "flow_level", keep=k1_per_video) as k1:
        counts = chain_counts("[28] chain", lambda: stages.run_stages(
            chain_cfg(root), stages.STAGES, SyntheticIUVProvider(), OFFLINE_SETS, io=io,
            device=dev, timer=timer), ("flow_level", "component_extents"),
            ("nms", "sor_solve", "warp_bilinear", "label_components"))
    seconds = {k: round(v, 4) for k, v in timer.seconds.items()}
    files = stage_files(root)
    log(f"  stage seconds {json.dumps(seconds)}")
    log(f"  files per stage folder {json.dumps(files)}")
    missing = [c for c in CROP_STREAMS if not files.get(c)]
    if missing or not files.get("CropBody"):
        raise AssertionError(f"crop streams not written: {missing}")
    if counts["flow_level"] != 2 * k1_per_video:
        raise AssertionError(f"K1 launched {counts['flow_level']} times for 2 videos")
    return root, counts, seconds, k1.calls


def check_offline_detections(root):
    """The IUV pickles' sanity: boxes finite and inside the padded frame
    (up to the resize's rounding), labels 0..24 of the best box's integer
    size, U and V in [0, 1]. Returns (frames, frames with a detection)."""
    import pickle

    import numpy as np

    from video_classification_tpu_torch.detect.provider import resized_shape

    scale, (nh, nw) = resized_shape(480, 640, 800, 1333)
    frames = found = 0
    for pkl in sorted((root / "4_IUV").rglob("*.pkl")):
        with pkl.open("rb") as f:
            items = pickle.load(f)
        for item in items:
            frames += 1
            boxes = item["pred_boxes_XYXY"]
            if boxes.shape[0] == 0:
                continue
            found += 1
            labels = item["pred_densepose"][0]["labels"]
            uv = item["pred_densepose"][0]["uv"]
            x1, y1, x2, y2 = boxes[int(np.argmax(item["scores"]))].astype(int)
            ok = (np.isfinite(boxes).all() and boxes[:, :2].min() >= 0
                  and boxes[:, 2].max() <= nw / scale and boxes[:, 3].max() <= nh / scale
                  and (boxes[:, 2:] >= boxes[:, :2]).all()
                  and labels.shape == (max(y2 - y1, 1), max(x2 - x1, 1))
                  and labels.dtype == np.uint8 and int(labels.max()) <= 24
                  and uv.shape == (2,) + labels.shape
                  and float(uv.min()) >= 0.0 and float(uv.max()) <= 1.0)
            if not ok:
                raise AssertionError(f"{item['file_name']}: detection out of range")
    return frames, found


def offline_densepose_full_width(dev, root):
    """[29] padded_to_iuv, then iuv_to_crop, with DensePoseIUVProvider at
    full width (depth 101, 800/1333, 1000 per level, 1000, 100, pooler 28,
    chart_topk 1, batch 8, bfloat16; seeded random weights,
    profile_preprocess.random_provider) on [28]'s 52 padded frames: seconds
    per frame, K2 and K3 launch, K1 and K4-K6 do not, the detections'
    sanity. Returns (counts, seconds, K3 calls, K2 calls)."""
    import shutil

    import video_classification_tpu_torch.detect.densepose as dp
    import video_classification_tpu_torch.ops.components as components
    from video_classification_tpu_torch.pipeline import stages
    from video_classification_tpu_torch.pipeline.frame_io import ArrayFrameIO
    from video_classification_tpu_torch.profile_preprocess import chain_cfg, random_provider
    from video_classification_tpu_torch.utils.profiling import StageTimer

    for d in [root / "4_IUV", *root.glob("Crop*")]:
        shutil.rmtree(d)
    t0 = time.perf_counter()
    provider = random_provider(dev)
    log(f"  provider: depth 101, {provider.model.compute_dtype}, budget "
        f"{provider.model.pre_nms_topk} / {provider.model.post_nms_topk} / "
        f"{provider.model.max_detections}; built in {time.perf_counter() - t0:.2f} s")
    timer = StageTimer(dev)
    with Recorder(dp, "nms") as k3, Recorder(components, "component_extents") as k2:
        counts = chain_counts("[29] IUV and crops", lambda: stages.run_stages(
            chain_cfg(root), ("iuv", "crop"), provider, OFFLINE_SETS, io=ArrayFrameIO(),
            device=dev, timer=timer), ("component_extents", "nms"),
            ("flow_level", "sor_solve", "warp_bilinear", "label_components"))
    seen, found = check_offline_detections(root)
    seconds = {k: round(v, 4) for k, v in timer.seconds.items()}
    log(f"  {seen} frames, {found} with a detection; seconds {json.dumps(seconds)}, per "
        f"frame {json.dumps({k: round(v / seen, 4) for k, v in seconds.items()})}")
    if seen != 52 or found == 0:
        raise AssertionError(f"[29]: {seen} frames, {found} detected")
    del provider
    return counts, seconds, k3.calls, k2.calls


def check_offline_kernels(dev, k1_calls, k3_calls, k2_calls):
    """[30] The kernels on the calls the offline chain made: K1 bit-equal
    on each of one video's 27 calls, its 65-pair 240x320 call timed; K3
    exact on every captured call, the RPN's (8, ~4663) into 1000 slots at
    0.7 and the box head's (8, 1000) into 100 at 0.5 timed; K2 exact on
    every frame's six box-sized part masks, the largest batch timed with its
    route and iterations. Each with its bound."""
    from video_classification_tpu_torch.ops.flow import DEFAULT_PARAMS as p
    from video_classification_tpu_torch.ops.flow_level import (flow_level,
                                                               flow_level_reference)

    err1 = 0.0
    for call in k1_calls:
        err1 = max(err1, require_equal("K1 offline", flow_level(*call),
                                       flow_level_reference(*call)))
    shapes = sorted({(c[0].shape[0],) + tuple(c[0].shape[1:3]) for c in k1_calls})
    log(f"  K1: {len(k1_calls)} calls of one video bit-equal (u, v, mx); shapes {shapes}")
    call = max(k1_calls, key=lambda c: c[0].numel())
    a1, a2, u, v = call[:4]
    rest = call[4:]
    b, h, w = u.shape
    ms = cuda_ms(lambda: flow_level(*call))
    _, plain = cuda_call_ms(lambda: flow_level_reference(*call))
    outers = int(executed_outers(lambda k: flow_level(a1, a2, u, v, k, *rest[1:]),
                                 p.n_outer).sum())
    bound_ms, bound_by = bound(outers * h * w * flow_ops_per_pixel_outer(3, p.n_sor),
                               (2 * a1.numel() + 4 * u.numel() + b) * 4)
    k1 = {"call": f"{b}x{h}x{w}", "ms": round(ms, 4), "plain_ms": round(plain, 4),
          "outers": outers, "bound_ms": round(bound_ms, 4), "bound_by": bound_by,
          "max_abs_err": err1}
    log(f"  K1 offline time {json.dumps(k1)}")

    # Every call exact; per slot count the first call of the largest batch timed.
    first = {}
    for i, (_, scores, max_out, _) in enumerate(k3_calls):
        if max_out not in first or scores.shape[0] > k3_calls[first[max_out]][1].shape[0]:
            first[max_out] = i
    k3 = {}
    for i, call in enumerate(k3_calls):
        row = nms_row("offline", *call, timed=i in first.values())
        if row is not None:
            k3[call[2]] = row
    if sorted(k3) != [100, 1000] or {k3[1000]["thr"], k3[100]["thr"]} != {0.7, 0.5}:
        raise AssertionError(f"K3 offline calls {sorted(k3)}")
    k3 = [k3[1000], k3[100]]
    log(f"  K3: {len(k3_calls)} offline calls exact")

    k2 = check_extents_calls("offline", k2_calls)
    return {"flow_level": k1, "nms": k3, "component_extents": k2}


def offline_small_against_cpu(dev, work):
    """[31] The chain small (a 10-frame 64x96 fixture through ArrayFrameIO,
    the synthetic provider, flow of 2 outers and 4 sweeps) on the card and
    on the CPU: the same files in every folder, images, pads, IUV pickles
    and the RGB, U, V and D crops equal, flow images and flow crops within
    +-1 on >= 99.9 %; then DensePoseIUVProvider at depth 50, float32, small
    budgets, card against CPU at the detector bars."""
    import pickle
    import shutil
    from pathlib import Path

    import numpy as np
    import torch

    from video_classification_tpu_torch.config import get_cfg
    from video_classification_tpu_torch.data.fixture import generate_raw_fixture
    from video_classification_tpu_torch.detect.provider import DensePoseIUVProvider
    from video_classification_tpu_torch.ops.flow import FlowParams
    from video_classification_tpu_torch.pipeline import stages
    from video_classification_tpu_torch.pipeline.frame_io import ArrayFrameIO
    from video_classification_tpu_torch.pipeline.iuv_contract import SyntheticIUVProvider
    from video_classification_tpu_torch.profile_preprocess import chain_cfg, random_provider

    io = ArrayFrameIO()
    roots = {k: Path(work) / f"small_{k}" for k in ("card", "cpu")}
    cfg = get_cfg()
    cfg.CHALEARN.ROOT = str(roots["card"])
    generate_raw_fixture(cfg, num_videos_per_set=1, num_classes=1, num_frames=10,
                         hw=(64, 96), sets=OFFLINE_SETS, io=io)
    shutil.copytree(roots["card"], roots["cpu"])
    for name, device in (("card", dev), ("cpu", "cpu")):
        stages.run_stages(chain_cfg(roots[name]), stages.STAGES, SyntheticIUVProvider(),
                          OFFLINE_SETS, FlowParams(n_outer=2, n_sor=4, min_width=16), io=io,
                          device=device)
    files = {k: sorted(p.relative_to(r).as_posix() for p in r.rglob("*") if p.is_file())
             for k, r in roots.items()}
    if files["card"] != files["cpu"]:
        raise AssertionError("[31]: the card and the CPU wrote different files")
    flow_files, worst = 0, 1.0
    for f in files["card"]:
        a, b = (roots[k] / f for k in ("card", "cpu"))
        if f.endswith(".pkl"):
            with a.open("rb") as fa, b.open("rb") as fb:
                pa, pb = pickle.load(fa), pickle.load(fb)
            same = len(pa) == len(pb) and all(
                np.array_equal(x[k], y[k]) for x, y in zip(pa, pb)
                for k in ("pred_boxes_XYXY", "scores")) and all(
                np.array_equal(x["pred_densepose"][0][k], y["pred_densepose"][0][k])
                for x, y in zip(pa, pb) for k in ("labels", "uv"))
        elif f.startswith("2_Flow/") or Path(f).name.startswith("F"):
            flow_files += 1
            worst = min(worst, within(torch.from_numpy(np.load(a)),
                                      torch.from_numpy(np.load(b)), 1))
            same = True
        else:
            same = a.read_bytes() == b.read_bytes()
        if not same:
            raise AssertionError(f"[31]: {f} differs between the card and the CPU")
    log(f"  small chain: {len(files['card'])} files, equal on the card and the CPU except "
        f"{flow_files} flow images and crops, worst within +-1 {worst:.6f}")
    if worst < FLOW_FRAC:
        raise AssertionError(f"[31]: flow within +-1 on {worst}")

    budget = dict(depth=50, pre_nms_topk=64, post_nms_topk=16, max_detections=4,
                  chart_pooler_size=14, min_size=160, max_size=400, batch_size=2,
                  compute_dtype="float32")
    card = random_provider(dev, **budget)
    cpu = DensePoseIUVProvider(
        state_dict={k: v.cpu() for k, v in card.model.state_dict().items()},
        device="cpu", **budget)
    pads = sorted((roots["cpu"] / "3_Pad").rglob("M_*/*.jpg"))
    frames = np.stack([io.imread(p) for p in pads])
    got, want = card.detect(frames, []), cpu.detect(frames, [])
    worst = {"box": 0.0, "score": 0.0, "chart": 1.0, "uv": 0.0, "compared": 0}
    for g, c in zip(got, want):
        if g.boxes_xyxy.shape != c.boxes_xyxy.shape:
            raise AssertionError(f"[31] detector: {g.boxes_xyxy.shape} vs {c.boxes_xyxy.shape}")
        if not c.boxes_xyxy.shape[0]:
            continue
        worst["box"] = max(worst["box"], float(np.abs(g.boxes_xyxy - c.boxes_xyxy).max()))
        worst["score"] = max(worst["score"], float(np.abs(g.scores - c.scores).max()))
        if np.array_equal(g.best_box(), c.best_box()):
            same = g.labels == c.labels
            worst["compared"] += 1
            worst["chart"] = min(worst["chart"], float(same.mean()))
            worst["uv"] = max(worst["uv"], float(np.abs(g.uv - c.uv)[:, same].max()))
    log(f"  small provider card vs cpu: {len(frames)} frames, {json.dumps(worst)}")
    if (worst["box"] > 1e-3 or worst["score"] > 1e-4 or worst["chart"] < 0.999
            or worst["uv"] > 1e-3 or worst["compared"] == 0):
        raise AssertionError(f"[31] detector: card and cpu disagree: {worst}")


# -- the v2 slice: RAFT, the converters, ChalearnGestureDataset, V2Trainer ---------

V2_PAIRS = 64  # the flow converter's batch of frame pairs
PEAK_BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)


def raft_weights_file(work):
    """The synthesized raft_large state_dict of seed 0 (torchvision's key
    grammar and shapes) saved as a .pth under ``work``."""
    from pathlib import Path

    from video_classification_tpu_torch.models.raft_convert import write_synthesized_checkpoint

    return write_synthesized_checkpoint(Path(work) / "raft_large_synthesized.pth")


def raft_from_file(path, dev, dtype):
    """RAFT (raft_large, 12 iterations) loaded through
    models/raft_convert.load_raft_checkpoint."""
    from video_classification_tpu_torch.models.raft import RAFT
    from video_classification_tpu_torch.models.raft_convert import load_raft_checkpoint

    return load_raft_checkpoint(path, RAFT(num_iters=12, dtype=dtype)).to(dev).eval()


def raft_full_width(dev, work, frames):
    """[32] RAFT raft_large at full width: 12 iterations on the converter's
    batch of 64 240x320 frame pairs, weights from the synthesized
    torchvision-grammar .pth through the port's loader, in bfloat16 and in
    float32 (TF32 off): ms per batch (CUDA events, 3 calls after a warm-up),
    pairs/s, peak memory, the bound of the counted operations at the dtype's
    peak; the flow finite. Returns {dtype: row}."""
    import torch

    from video_classification_tpu_torch.models.raft import flow_ops_per_pair

    path = raft_weights_file(work)
    x = torch.from_numpy(frames[:V2_PAIRS + 1]).to(dev).flip(-1).float() / 255.0  # RGB
    im1, im2 = x[:-1].contiguous(), x[1:].contiguous()
    ops = flow_ops_per_pair(240, 320) * V2_PAIRS
    rows = {}
    for dtype, peak_ops in ((torch.bfloat16, PEAK_BF16_OPS_PER_S),
                            (torch.float32, PEAK_F32_OPS_PER_S)):
        model = raft_from_file(path, dev, dtype)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            ms = cuda_ms(lambda: model(im1, im2), reps=3, warmup=1)
            up, coarse = model(im1, im2)
        peak = torch.cuda.max_memory_allocated()
        finite = bool(torch.isfinite(up).all()) and bool(torch.isfinite(coarse).all())
        bound_ms = 1e3 * ops / peak_ops
        name = str(dtype).replace("torch.", "")
        rows[name] = {"ms": ms, "pairs_per_s": V2_PAIRS / ms * 1e3,
                      "peak_gib": peak / 2 ** 30, "bound_ms": bound_ms,
                      "max_abs_flow": float(up.abs().max())}
        log(f"  RAFT {name}: {V2_PAIRS} pairs 240x320, 12 iterations: {ms:.3f} ms per batch, "
            f"{V2_PAIRS / ms * 1e3:.2f} pairs/s, peak {peak / 2**30:.3f} GiB; "
            f"{ops / V2_PAIRS / 1e9:.1f} GFLOP a pair counted, bound {bound_ms:.3f} ms at the "
            f"{name} peak; flow finite {finite}, max|flow| {rows[name]['max_abs_flow']:.3f} px")
        if not finite or up.shape != (V2_PAIRS, 240, 320, 2) or coarse.shape != (
                V2_PAIRS, 30, 40, 2):
            raise AssertionError(f"RAFT {name}: shapes {tuple(up.shape)}, "
                                 f"{tuple(coarse.shape)}, finite {finite}")
        del model, up, coarse
    return rows


def raft_against_cpu(dev, work, frames):
    """[33] RAFT at 64x96, 12 iterations, float32, TF32 off, the same
    synthesized weights, on the card and on the CPU: the up-flow and the
    coarse flow within 5e-3. Failing that, the card's float64 run must give
    the CPU's float64 flow within 1e-6 and the float32 gap must be within
    twice the card's own float32 spread (its flow with the batch's pairs
    permuted), as [25] holds the train steps. Returns the bar that held."""
    import torch

    path = raft_weights_file(work)
    x = torch.from_numpy(frames[:5, 88:152, 112:208]).flip(-1).float() / 255.0
    im1, im2 = x[:-1].contiguous(), x[1:].contiguous()
    rows = torch.tensor([2, 0, 3, 1])

    def run(device, dtype, perm=None):
        model = raft_from_file(path, device, torch.float32).to(dtype)
        a, b = (im1, im2) if perm is None else (im1[perm], im2[perm])
        with torch.inference_mode():
            up, coarse = model(a.to(device, dtype), b.to(device, dtype))
        if perm is not None:
            inverse = torch.argsort(perm)
            up, coarse = up[inverse], coarse[inverse]
        return up.double().cpu(), coarse.double().cpu()

    card, cpu = run(dev, torch.float32), run("cpu", torch.float32)
    err = max(float((a - b).abs().max()) for a, b in zip(card, cpu))
    scale = float(cpu[0].abs().max())
    log(f"  RAFT 4 pairs 64x96 card vs cpu, float32: max|dflow| {err:.3e} (flow up to "
        f"{scale:.3f} px)")
    if err <= 5e-3:
        log("  bar held: 5e-3")
        return "5e-3"
    card64, cpu64 = run(dev, torch.float64), run("cpu", torch.float64)
    err64 = max(float((a - b).abs().max()) for a, b in zip(card64, cpu64))
    spread = max(float((a - b).abs().max()) for a, b in zip(run(dev, torch.float32, rows),
                                                            card))
    log(f"  float64: card vs cpu {err64:.3e}; the card's float32 flow moves by {spread:.3e} "
        f"with the pairs permuted")
    if err64 > 1e-6 or err > 2 * spread:
        raise AssertionError(f"RAFT card vs cpu: {err} (float64 {err64}, spread {spread})")
    log(f"  bar held: twice the card's float32 spread ({2 * spread:.3e})")
    return f"2 x spread {2 * spread:.3e}"


def check_v2_outputs(root, frames: int):
    """The v2 folders of ``root``: per M_ video two flow channel files of
    frames - 1 frames, an IUV pkl of ``frames`` results, two UV channel
    files and a [frames][25] box pkl of None or int xyxy with x2 >= x1.
    Returns (files per v2 folder, boxes found)."""
    import pickle

    from video_classification_tpu_torch.pipeline.frame_io import ArrayFrameIO
    from video_classification_tpu_torch.v2 import VideoIO

    vio = VideoIO(ArrayFrameIO())
    found = 0
    for m in sorted((root / "1_Sample").rglob("M_*.avi")):
        rel = m.relative_to(root / "1_Sample")
        for base, n in (("2_Flow_New", frames - 1), ("5_UV_Video", frames)):
            for c in (0, 1):
                f = root / base / rel.parent / f"{c}_{m.name}"
                if vio.frame_count(f) != n or vio.frame_size(f) != vio.frame_size(m):
                    raise AssertionError(f"{f}: {vio.frame_count(f)} frames")
        with (root / "4_IUV_New" / rel.with_suffix(".pkl")).open("rb") as fh:
            if len(pickle.load(fh)) != frames:
                raise AssertionError(f"{rel}: IUV pkl length")
        with (root / "6_Box" / rel.with_suffix(".pkl")).open("rb") as fh:
            boxes = pickle.load(fh)
        if len(boxes) != frames or any(len(b) != 25 for b in boxes):
            raise AssertionError(f"{rel}: box pkl is not a [{frames}][25] list")
        for b in (b for frame in boxes for b in frame if b is not None):
            if len(b) != 4 or b[2] < b[0] or b[3] < b[1]:
                raise AssertionError(f"{rel}: box {b}")
            found += 1
    files = {d: sum(1 for p in (root / d).rglob("*") if p.is_file())
             for d in ("2_Flow_New", "4_IUV_New", "5_UV_Video", "6_Box")}
    return files, found


def v2_convert_full_width(dev, work):
    """[34] v2-convert's four converters at full width through ArrayFrameIO
    on one 130-frame 240x320 M_ video in train and one in test: (A) the
    variational flow with the synthetic provider, (B) with the DensePose
    provider (profile_preprocess.random_provider), (C) the RAFT flow
    (float32, the synthesized weights) with the synthetic provider, each on a
    fresh copy of the sampled fixture: seconds per converter and per video,
    files per folder, the outputs' shapes; the launch counts zeroed just
    before and read just after each: K1 and K2 launch in A and B, K3 only in
    B, K1 not in C, K4-K6 never. K2's calls in A (24 masks a frame at the
    240x320 box, wide words) and in B (24 at each DensePose box) are kept
    and each held exactly against the plain version (``check_extents_calls``).
    Returns (A's root, B's counts, the seconds of each run, K2's rows of A
    and B)."""
    import shutil
    from contextlib import nullcontext
    from pathlib import Path

    import torch

    import video_classification_tpu_torch.ops.components as components
    from video_classification_tpu_torch.pipeline.frame_io import ArrayFrameIO
    from video_classification_tpu_torch.pipeline.iuv_contract import SyntheticIUVProvider
    from video_classification_tpu_torch.profile_preprocess import (FRAMES, chain_cfg,
                                                                   random_provider)
    from video_classification_tpu_torch.profile_v2 import run_v2_convert, write_v2_fixture
    from video_classification_tpu_torch.utils.profiling import StageTimer

    io = ArrayFrameIO()
    fixture = Path(work) / "v2_fixture"
    t0 = time.perf_counter()
    write_v2_fixture(fixture, io)
    log(f"  fixture: one {FRAMES}-frame 240x320 M_/K_ pair per set, sampled, in "
        f"{time.perf_counter() - t0:.2f} s")
    per_op = ("sor_solve", "warp_bilinear", "label_components")
    runs = {
        "A variational + synthetic": ("variational", SyntheticIUVProvider, None,
                                      ("flow_level", "component_extents"), ("nms",) + per_op),
        "B variational + DensePose": ("variational", lambda: random_provider(dev), None,
                                      ("flow_level", "component_extents", "nms"), per_op),
        "C RAFT + synthetic": ("raft", SyntheticIUVProvider, lambda: raft_weights_file(work),
                               ("component_extents",), ("flow_level", "nms") + per_op),
    }
    out, seconds, roots, k2 = {}, {}, {}, {}
    for what, (method, make_provider, weights, must, absent) in runs.items():
        root = Path(work) / f"v2_{what[0]}"
        shutil.copytree(fixture, root)
        provider = make_provider()
        checkpoint = weights() if weights else None
        timer = StageTimer(dev)
        keep = method == "variational"  # C's part masks are A's
        t0 = time.perf_counter()
        with Recorder(components, "component_extents") if keep else nullcontext() as rec:
            out[what] = chain_counts(f"[34] {what}", lambda: run_v2_convert(
                chain_cfg(root), io, dev, provider, method, timer, checkpoint), must, absent)
        total = time.perf_counter() - t0
        files, found = check_v2_outputs(root, FRAMES)
        seconds[what] = {k: round(v / 2, 4) for k, v in timer.seconds.items()}
        log(f"  {what}: {total:.2f} s for 2 videos; seconds per video by converter "
            f"{json.dumps(seconds[what])}; files {json.dumps(files)}; {found} part boxes")
        roots[what] = root
        del provider, checkpoint
        if keep:
            k2[what[0]] = check_extents_calls(f"[34] {what[0]}", rec.calls)
            del rec
            torch.cuda.empty_cache()
    if out["A variational + synthetic"]["flow_level"] != 2 * 27:
        raise AssertionError("[34]: K1 did not run 27 calls a video")
    for what in ("B variational + DensePose", "C RAFT + synthetic"):
        shutil.rmtree(roots[what])
    return roots["A variational + synthetic"], out["B variational + DensePose"], seconds, k2


def v2_train_full_width(dev, root):
    """[35] V2Trainer at full width (SlowFast-R50 with (5, 2) pathways,
    depth 50, INPUT_SIZE 192, CLIP_LEN 20, 249 classes, bf16, SGD at
    slowfast-HTAH's LR): 3 warm-up and 20 timed train steps on one batch of
    random clips (the largest of 16, 8, 4 that fits): ms per step, clips/s,
    peak memory, the loss lower after 22 steps than at the first; then
    train_epoch(0) in DEBUG and run_eval() on [34]'s folders (batch 1).
    Returns (seconds per step, batch, peak bytes)."""
    import numpy as np
    import torch

    from video_classification_tpu_torch.pipeline.frame_io import ArrayFrameIO
    from video_classification_tpu_torch.profile_v2 import time_v2_train_steps, v2_train_cfg
    from video_classification_tpu_torch.v2 import V2Trainer

    io = ArrayFrameIO()
    for batch in (16, 8, 4):
        cfg = v2_train_cfg(root, batch)
        trainer = V2Trainer(cfg, io=io, device=dev)
        try:
            step_s, losses, peak = time_v2_train_steps(trainer, batch, 20)
            break
        except torch.cuda.OutOfMemoryError:
            log(f"  batch {batch} does not fit in device memory; halving it")
            del trainer
            torch.cuda.empty_cache()
    log(f"  V2Trainer: depth {cfg.MODEL.DEPTH}, {cfg.CHALEARN.NUM_CLASS} classes, "
        f"{cfg.MODEL.INPUT_SIZE} px, CLIP_LEN {cfg.CHALEARN.CLIP_LEN}, "
        f"{cfg.CUDA.COMPUTE_DTYPE}, SGD lr {cfg.MODEL.LR} momentum 0.9; batch {batch}: "
        f"{step_s * 1e3:.3f} ms per step, {batch / step_s:.3f} clips/s, peak "
        f"{peak / 2**30:.3f} GiB; loss {losses[0]:.4f} at the first step, {losses[10]:.4f} "
        f"after 10, {losses[-1]:.4f} after 22")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"the V2Trainer loss did not fall on a repeated batch: {losses}")
    del trainer
    torch.cuda.empty_cache()
    cfg = v2_train_cfg(root, 1)
    trainer = V2Trainer(cfg, io=io, device=dev)
    t0 = time.perf_counter()
    m = trainer.train_epoch(0)
    y = trainer.run_eval()
    log(f"  train_epoch(0) in DEBUG: loss {m['loss']:.4f}; run_eval(): {len(y['sv'])} video, "
        f"{y['ps'].shape[0]} clips, acc {y['acc']:.3f}; {time.perf_counter() - t0:.2f} s")
    if not np.isfinite(m["loss"]) or y["ps"].shape != (6, 249) or y["sv"] != [6]:
        raise AssertionError(f"[35] epoch and eval: {m}, {y['ps'].shape}, {y['sv']}")
    return step_s, batch, peak


def v2_small_against_cpu(dev, work):
    """[36] A 10-frame 64x96 v2 chain (two M_ videos per set through
    ArrayFrameIO, the synthetic provider, flow of 2 outers and 4 sweeps) on
    the card and on the CPU: the same files, the flow videos within +-1 on
    >= 99.9 %, the UV videos and box pkls equal; the dataset's clips from
    the two roots equal in rgb and uv and within +-1 in flow, and
    resize_linear_u8 on a 7-channel exact-2x crop equal on the card and the
    CPU; one depth-18 float32 V2Trainer step at [19]'s bars; render_iuv_boxes
    writing equal frames from both roots."""
    import pickle
    import random
    import shutil
    from pathlib import Path

    import numpy as np
    import torch

    from video_classification_tpu_torch.data.dataset import train_batches
    from video_classification_tpu_torch.data.fixture import generate_raw_fixture
    from video_classification_tpu_torch.ops.flow import FlowParams
    from video_classification_tpu_torch.ops.image import resize_linear_u8
    from video_classification_tpu_torch.pipeline import stages
    from video_classification_tpu_torch.pipeline.frame_io import ArrayFrameIO
    from video_classification_tpu_torch.pipeline.iuv_contract import SyntheticIUVProvider
    from video_classification_tpu_torch.profile_preprocess import chain_cfg
    from video_classification_tpu_torch.profile_v2 import run_v2_convert
    from video_classification_tpu_torch.tools import render_iuv_boxes
    from video_classification_tpu_torch.v2 import ChalearnGestureDataset, V2Trainer

    io = ArrayFrameIO()
    roots = {k: Path(work) / f"v2_small_{k}" for k in ("card", "cpu")}
    cfg = chain_cfg(roots["card"])
    generate_raw_fixture(cfg, num_videos_per_set=2, num_classes=1, num_frames=10,
                         hw=(64, 96), sets=OFFLINE_SETS, io=io)
    stages.sample_data(cfg, OFFLINE_SETS)
    shutil.copytree(roots["card"], roots["cpu"])
    flow = FlowParams(n_outer=2, n_sor=4, min_width=16)
    for name, device in (("card", dev), ("cpu", "cpu")):
        run_v2_convert(chain_cfg(roots[name]), io, device, SyntheticIUVProvider(),
                       flow_params=flow)
    files = {k: sorted(p.relative_to(r).as_posix() for p in r.rglob("*") if p.is_file())
             for k, r in roots.items()}
    if files["card"] != files["cpu"]:
        raise AssertionError("[36]: the card and the CPU wrote different files")
    worst, flows = 1.0, 0
    for f in files["card"]:
        a, b = (roots[k] / f for k in ("card", "cpu"))
        if f.startswith("2_Flow_New/"):
            flows += 1
            worst = min(worst, within(torch.from_numpy(np.load(a)),
                                      torch.from_numpy(np.load(b)), 1))
        elif f.endswith(".pkl") and f.startswith("6_Box/"):
            with a.open("rb") as fa, b.open("rb") as fb:
                if pickle.load(fa) != pickle.load(fb):
                    raise AssertionError(f"[36]: {f} differs")
        elif f.startswith("5_UV_Video/") and a.read_bytes() != b.read_bytes():
            raise AssertionError(f"[36]: {f} differs")
    log(f"  small v2 chain: {len(files['card'])} files; {flows} flow videos within +-1 on "
        f"{worst:.6f}; UV videos and box pkls equal")
    if worst < FLOW_FRAC:
        raise AssertionError(f"[36]: flow within +-1 on {worst}")

    def v2cfg(root):
        c = chain_cfg(root)
        c.CHALEARN.NUM_CLASS = 3
        c.CHALEARN.CLIP_LEN = 4
        c.CHALEARN.BATCH_SIZE = 2
        c.MODEL.INPUT_SIZE = 64
        c.MODEL.DEPTH = 18
        c.MODEL.NAME = "slowfast-v2-small"
        c.CUDA.COMPUTE_DTYPE = "float32"
        c.DEBUG = True
        return c

    clips = [ChalearnGestureDataset(v2cfg(roots[k]), "test", io=io).get_eval_clips(
        0, random.Random(3))["clips"] for k in ("card", "cpu")]
    clip_frac = min(within(torch.from_numpy(a[..., 5:]), torch.from_numpy(b[..., 5:]), 1)
                    for a, b in zip(*clips))
    if not all(np.array_equal(a[..., :5], b[..., :5]) for a, b in zip(*clips)):
        raise AssertionError("[36]: the dataset's rgb/uv clips differ")
    crop = torch.randint(0, 256, (4, 128, 96, 7), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(36))
    if not torch.equal(resize_linear_u8(crop.to(dev), (64, 48)).cpu(),
                       resize_linear_u8(crop, (64, 48))):
        raise AssertionError("[36]: the 7-channel exact-2x resize differs on the card")
    log(f"  dataset clips: rgb/uv equal, flow within +-1 on {clip_frac:.6f}; the "
        f"7-channel 2x resize equal on the card and the CPU")
    if clip_frac < FLOW_FRAC:
        raise AssertionError(f"[36]: clip flow within +-1 on {clip_frac}")

    step_card_vs_cpu(dev, "V2Trainer", lambda c, d: V2Trainer(c, io=io, device=d),
                     v2cfg(roots["cpu"]),
                     lambda t: next(train_batches(t.train_dataset, 2, seed=0)),
                     torch.tensor([[0, 3], [12, 5]]))

    pkl = sorted((roots["card"] / "4_IUV_New").rglob("*.pkl"))[0]
    rel = pkl.relative_to(roots["card"] / "4_IUV_New").with_suffix(".avi")
    for k in ("card", "cpu"):
        n = render_iuv_boxes(roots[k] / "4_IUV_New" / rel.with_suffix(".pkl"),
                             roots[k] / "1_Sample" / rel, roots[k] / "render", io=io)
    drawn = {k: sorted((roots[k] / "render").iterdir()) for k in roots}
    if n != 10 or [p.name for p in drawn["card"]] != [p.name for p in drawn["cpu"]] or not all(
            a.read_bytes() == b.read_bytes() for a, b in zip(drawn["card"], drawn["cpu"])):
        raise AssertionError("[36]: render_iuv_boxes wrote different frames")
    log(f"  render_iuv_boxes: {n} frames, equal from both roots")


# -- the parallel slice: native loader, K3 past 8192, remat, data parallelism ------


def cv2_jpeg_encoder():
    """(whether cv2 imports and encodes a JPEG, what it said)."""
    try:
        import cv2
        import numpy as np

        ok, buf = cv2.imencode(".jpg", np.zeros((8, 8, 3), np.uint8))
        return bool(ok) and len(buf) > 0, f"cv2 {cv2.__version__}"
    except Exception as e:  # noqa: BLE001 - reported, not hidden
        return False, f"{type(e).__name__}: {e}"


def native_loader_full_width(dev, root: str):
    """[37] the native clip loader on this machine: whether jpeglib.h is
    found, whether cv2 encodes JPEG, whether the library builds (a build
    that fails while jpeglib.h is there fails the run). Then, where cv2
    writes JPEG: a crop-folder fixture at full width (16 CropHTAH videos of
    20 frames, crops of 184-200 px, 9 files a frame), a Trainer on it with
    DATA.BACKEND auto (which must take the native loader where it builds,
    and cv2 where it does not, as the JAX package's would), the decode of
    one batch of 16 timed twice, and 3 train steps on it (bf16); where the
    loader does not build, why, in plain words. Returns a dict of what was
    found and measured."""
    import numpy as np
    import torch

    from video_classification_tpu_torch.data.dataset import ChalearnVideoDataset, train_batches
    from video_classification_tpu_torch.data.fixture import generate_fixture
    from video_classification_tpu_torch.engine import Trainer
    from video_classification_tpu_torch.native import loader
    from video_classification_tpu_torch.utils.labels import write_labels

    cxx = loader.compiler()
    header = loader.jpeg_header_found(cxx)
    encoder, cv2_said = cv2_jpeg_encoder()
    t0 = time.perf_counter()
    built = loader.native_available()
    build_s = time.perf_counter() - t0
    found = {"compiler": cxx, "jpeglib_h": header, "cv2_jpeg": encoder, "built": built,
             "build_s": round(build_s, 3)}
    log(f"  C++ compiler {cxx}; jpeglib.h found: {header}; cv2 JPEG encoder: {encoder} "
        f"({cv2_said}); native loader built: {built} ({build_s:.2f} s)"
        + ("" if built else f": {loader.build_error()}"))
    if header and not built:
        raise AssertionError(f"jpeglib.h is here but the loader does not build: "
                             f"{loader.build_error()}")
    cfg = htah_cfg(root)
    cfg.CHALEARN.BATCH_SIZE = 16
    cfg.DATA.BACKEND = "auto"
    want = "native" if built else "cv2"
    if not built:
        log("  the native loader cannot be built on this machine (no libjpeg header); "
            "DATA.BACKEND auto reads with cv2 here, as the JAX package's would")
    if not encoder:
        log("  cv2 cannot write a JPEG: no JPEG fixture is written on this machine")
        return found
    t0 = time.perf_counter()
    generate_fixture(cfg, num_videos_per_set=16, num_classes=249, frames_per_video=20,
                     crops=("CropHTAH",), sets=("train",), base_size=192)
    write_labels(cfg, "test", [])
    write_s = time.perf_counter() - t0
    trainer = Trainer(cfg, device=dev)
    ds = trainer.train_dataset
    if ds.decoder != want:
        raise AssertionError(f"DATA.BACKEND auto took {ds.decoder}, not {want}")
    decode = []
    for _ in range(2):
        t0 = time.perf_counter()
        batch = next(train_batches(ds, 16, seed=0))
        decode.append(time.perf_counter() - t0)
    x = torch.from_numpy(batch["x"]).to(dev)
    labels = torch.from_numpy(batch["label"]).to(dev)
    steps = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(trainer.train_step(x, labels)["loss"])
        steps.append(time.perf_counter() - t0)
        if not np.isfinite(loss):
            raise AssertionError(f"[37] train step loss {loss}")
    cv2_cfg = cfg.clone()
    cv2_cfg.DATA.BACKEND = "cv2"
    if built:  # the other decoder on one clip, for scale
        a = ChalearnVideoDataset(cv2_cfg, "train").get_train_clip(0, random.Random(0))["x"]
        b = ds.get_train_clip(0, random.Random(0))["x"]
        found["native_vs_cv2_mean_abs"] = float(np.abs(a.astype(int) - b.astype(int)).mean())
    found.update({"auto": ds.decoder, "fixture_write_s": round(write_s, 3),
                  "decode_batch16_s": [round(d, 4) for d in decode],
                  "step_batch16_s": [round(s, 4) for s in steps], "loss": loss})
    log(f"  auto took {ds.decoder}; fixture of 16 x 20 frames x 9 JPEGs written "
        f"by cv2 in {write_s:.2f} s; decode of a batch of 16 clips "
        f"{[round(d, 3) for d in decode]} s against a train step {[round(s, 4) for s in steps]} "
        f"s (bf16, 249 classes, 192 px, CLIP_LEN 20); {json.dumps(found)}")
    del trainer, x
    torch.cuda.empty_cache()
    return found


def nms_past_8192(dev):
    """[38] K3's device-memory route: N = 10000 and 20000 dense boxes, 4
    frames, thresholds 0.7 and 0.5, 1000 slots, exact against nms_reference,
    each timed beside its bound (the K3 row's form)."""
    import numpy as np
    import torch

    from video_classification_tpu_torch.detect.nms import route
    from video_classification_tpu_torch.utils.cuda import build

    rows = []
    for n in (10000, 20000):
        if route(n) != "device" or build().nms_route(n) != "device":
            raise AssertionError(f"K3 route of N = {n}: {route(n)}, {build().nms_route(n)}")
        frames = [nms_boxes(n, n + f, 1200.0) for f in range(4)]
        boxes = torch.from_numpy(np.stack([b for b, _ in frames])).to(dev)
        scores = torch.from_numpy(np.stack([s for _, s in frames])).to(dev)
        for thr in (0.7, 0.5):
            rows.append(nms_row("past 8192 (device-memory route)", boxes, scores, 1000, thr))
    if build().nms_route(8192) != "shared":
        raise AssertionError("K3 at N = 8192 left the shared-memory route")
    return rows


def remat_full_width(dev, root: str):
    """[39] slowfast-HTAH at full width (bf16, synthetic clips) with
    CUDA.REMAT off, "" and "conv": batch 16, 2 warm-up and 5 timed train
    steps each (ms per step, peak memory), the running statistics after the
    first step equal to those without remat (same weights, batch and
    offsets; cuDNN deterministic for that step); then "conv" at batches 32,
    48, 64 and 96
    until one raises CUDA out-of-memory (that rung is the measured limit;
    any other exception fails)."""
    import torch

    from video_classification_tpu_torch.engine import Trainer
    from video_classification_tpu_torch.profile_train import train_cfg

    def trainer_for(policy, batch):
        cfg = train_cfg(root, batch, synthetic_videos=batch)
        cfg.CUDA.REMAT = policy is not None
        cfg.CUDA.REMAT_POLICY = policy or ""
        return Trainer(cfg, device=dev)

    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randint(0, 256, (16, 20, 192, 192, 21), generator=g, device=dev,
                      dtype=torch.uint8)
    labels = torch.randint(0, 249, (16,), generator=g, device=dev)
    out, stats = {}, {}
    for policy in (None, "", "conv"):
        trainer = trainer_for(policy, 16)
        offsets = trainer.mm.crop_offsets(x, trainer.generator)
        torch.backends.cudnn.deterministic = True  # the compared step only
        try:
            trainer.train_step(x, labels, offsets=offsets)
            stats[policy] = {k: v.clone() for k, v in trainer.model.state_dict().items()
                             if "running_" in k}
        finally:
            torch.backends.cudnn.deterministic = False
        trainer.train_step(x, labels, offsets=offsets)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(5):
            loss = trainer.train_step(x, labels, offsets=offsets)["loss"]
        float(loss)
        out[str(policy)] = {"ms": round((time.perf_counter() - t0) / 5 * 1e3, 3),
                            "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3)}
        del trainer
        torch.cuda.empty_cache()
    for policy in ("", "conv"):
        diff = max(float((stats[policy][k] - v).abs().max()) for k, v in stats[None].items())
        same = all(torch.equal(stats[policy][k], v) for k, v in stats[None].items())
        out[str(policy)]["stats_max_abs_diff"] = diff
        log(f"  remat {policy!r}: running statistics after one step "
            f"{'bit-equal to' if same else f'differ by {diff:.3e} from'} no remat")
        if not same:
            raise AssertionError(f"remat {policy!r} changed the running statistics")
    log(f"  batch 16, bf16: {json.dumps(out)}")
    ladder = []
    del x
    torch.cuda.empty_cache()
    for batch in (32, 48, 64, 96):
        trainer = xb = None
        try:
            trainer = trainer_for("conv", batch)
            xb = torch.randint(0, 256, (batch, 20, 192, 192, 21), generator=g, device=dev,
                               dtype=torch.uint8)
            lb = torch.randint(0, 249, (batch,), generator=g, device=dev)
            torch.cuda.reset_peak_memory_stats()
            trainer.train_step(xb, lb)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(trainer.train_step(xb, lb)["loss"])
            rung = {"batch": batch, "ms": round((time.perf_counter() - t0) * 1e3, 3),
                    "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3)}
            log(f"  remat 'conv' batch {batch}: {json.dumps(rung)}")
            ladder.append(rung)
        except torch.cuda.OutOfMemoryError:
            log(f"  remat 'conv' batch {batch}: CUDA out of memory: the measured limit")
            ladder.append({"batch": batch, "oom": True})
            break
        finally:
            del trainer, xb
            torch.cuda.empty_cache()
    out["ladder"] = ladder
    return out


WORKER_TIMEOUT_S = 600


def run_workers(scenario: str, out_dir: str, n: int):
    """``python3 chip_smoke.py --worker scenario out_dir`` as ``n`` ranks
    through ``parallel.multihost.launch_ranks`` (the torchrun environment,
    a free local port, every rank killed if they outlast the timeout).
    Returns their stdouts; raises with a failed rank's error output."""
    from pathlib import Path

    from video_classification_tpu_torch.parallel.multihost import launch_ranks

    here = Path(__file__).resolve()
    outs = launch_ranks(lambda r: [str(here), "--worker", scenario, out_dir], n,
                        cwd=here.parent, timeout_s=WORKER_TIMEOUT_S)
    for r, (rc, out, err) in enumerate(outs):
        for line in out.splitlines():
            log(f"    rank {r}: {line}")
        if rc != 0:
            raise AssertionError(f"{scenario} rank {r} exited {rc}: {err.strip()[-3000:]}")
    return [o[1] for o in outs]


def dp_cfg(root: str, batch: int = 16):
    """slowfast-HTAH at full width in float32 on 32 synthetic train and
    test videos of 20 frames (two steps of 16 an epoch; one eval clip a
    video)."""
    from video_classification_tpu_torch.profile_train import train_cfg

    cfg = train_cfg(root, batch, synthetic_videos=32, debug=False)
    cfg.DATA.SYNTHETIC_SEQ_LEN = 20
    cfg.CUDA.COMPUTE_DTYPE = "float32"
    cfg.MODEL.MAX_EPOCH = 1
    return cfg


def dp_run(cfg, dev):
    """One epoch (its steps timed) and the eval on the trained weights, head
    dropout 0 (as [19]; the global-batch dropout of ranks is held on the
    CPU); returns numpy/tensor results for comparison."""
    import torch

    from video_classification_tpu_torch.engine import Trainer

    trainer = Trainer(cfg, device=dev)
    no_dropout(trainer.model)
    step, losses, times, grads = trainer.train_step, [], [], {}

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(*args, **kwargs)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
        if not grads:  # the first step's, from the same parameters everywhere
            grads.update({k: p.grad.detach().cpu() for k, p in
                          trainer.model.named_parameters()})
        return m

    trainer.train_step = timed
    trainer.train_epoch(0)
    state = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
    ev = trainer.run_eval()
    return {"losses": losses, "step_s": times, "state": state, "grads": grads,
            "eval": {k: ev[k] for k in ("ps", "t", "acc", "sv")},
            "n_processes": trainer.n_processes}


def first_step_spread(cfg, dev):
    """float32's resolution of the first step's gradient on the card: the
    one-process gradient of the first global batch with its rows (and their
    crop offsets) in order and permuted, from fresh trainers (dropout 0);
    returns (in order, permuted) as {name: float64 numpy}."""
    import torch

    from video_classification_tpu_torch.data.dataset import train_batches
    from video_classification_tpu_torch.engine import Trainer

    out = []
    for perm in (None, torch.tensor([(i * 5 + 3) % 16 for i in range(16)])):
        trainer = Trainer(cfg, device=dev)
        no_dropout(trainer.model)
        b = next(train_batches(trainer.train_dataset, 16, seed=int(cfg.CUDA.SEED)))
        x = torch.from_numpy(b["x"]).to(dev)
        labels = torch.from_numpy(b["label"]).to(dev)
        offsets = trainer.mm.crop_offsets(x, trainer.generator)
        if perm is not None:
            x, labels, offsets = x[perm.to(dev)], labels[perm.to(dev)], offsets[perm.to(dev)]
        trainer.train_step(x, labels, offsets=offsets)
        out.append({k: p.grad.double().cpu().numpy()
                    for k, p in trainer.model.named_parameters()})
        del trainer, x
        torch.cuda.empty_cache()
    return out


def worker(scenario: str, out_dir: str) -> int:
    """One rank of [40] ('dp', 'nccl') or [41] ('temporal'), started by
    run_workers under the torchrun environment."""
    import os
    from pathlib import Path

    import numpy as np
    import torch
    import torch.nn.functional as F

    from video_classification_tpu_torch.parallel.multihost import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not initialize_distributed(timeout_s=WORKER_TIMEOUT_S):
        raise SystemExit("worker: no torch.distributed environment")
    rank = int(os.environ["RANK"])
    out = Path(out_dir)
    dev = torch.device("cuda", torch.cuda.current_device())
    if scenario in ("dp", "nccl"):
        cfg = dp_cfg(str(out / "ckpt"), 16 if scenario == "dp" else 8)
        if scenario == "nccl":
            cfg.DATA.SYNTHETIC_NUM_VIDEOS = 8
        result = dp_run(cfg, dev)
        result["backend"] = torch.distributed.get_backend()
        print(f"{scenario}: loss {result['losses']}, step s {result['step_s']}", flush=True)
    elif scenario == "temporal":
        from video_classification_tpu_torch.parallel import conv3d_temporal_sharded
        from video_classification_tpu_torch.parallel.temporal import gather_t, shard_t

        x, w = temporal_full_width()
        x, w = x.to(dev), w.to(dev)
        y = conv3d_temporal_sharded(shard_t(x), w)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            y = conv3d_temporal_sharded(shard_t(x), w)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 3 * 1e3
        full = gather_t(y)
        want = F.conv3d(x, w, padding=(1, 0, 0))
        err = float((full - want).abs().max())
        scale = float(want.abs().max())
        result = {"max_abs_err": err, "scale": scale, "ms": ms,
                  "local_shape": list(y.shape), "equal": bool(torch.equal(full, want))}
        print(f"temporal: {json.dumps(result)}", flush=True)
        if not np.isfinite(err) or err > 1e-4 * max(scale, 1.0):
            raise AssertionError(f"sharded temporal conv differs by {err:.3e} (scale {scale:.3e})")
    else:
        raise SystemExit(f"unknown worker scenario {scenario!r}")
    torch.save(result, out / f"{scenario}_rank{rank}.pt")
    torch.distributed.destroy_process_group()
    return 0


def temporal_full_width():
    """A SlowFast-R50 slow-pathway res4 conv_a at full width: (16, 640, 20,
    24, 24) input (CropHTAH 192 px at 1/8, after the fusion's 128 extra
    channels), (256, 640, 3, 1, 1) weights, float32 from numpy seeds."""
    import numpy as np
    import torch

    rng = np.random.RandomState(41)
    x = torch.from_numpy(rng.standard_normal((16, 640, 20, 24, 24)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((256, 640, 3, 1, 1))
                          / np.sqrt(640 * 3)).astype(np.float32))
    return x, w


def data_parallel_full_width(dev, root: str):
    """[40] two gloo ranks sharing the card train slowfast-HTAH at full width
    (float32, TF32 off, global batch 16: 8 rows a rank) for one epoch of two
    steps, then evaluate (sharded decode); the ranks are bit-equal to each
    other and match the one-process run (first-step loss within 1e-5,
    state and gradients at the train bars, eval clip order, labels and
    accuracy exact, scores within 5e-3); one NCCL rank (world size 1)
    takes one epoch of one step. Head dropout 0. ms per step of each."""
    import numpy as np
    import torch
    from pathlib import Path

    work = Path(tempfile.mkdtemp(prefix="dp_", dir=root))
    torch.cuda.empty_cache()
    run_workers("dp", str(work), 2)
    ranks = [torch.load(work / f"dp_rank{r}.pt", weights_only=False) for r in range(2)]
    a, b = ranks
    if a["backend"] != "gloo" or a["n_processes"] != 2:
        raise AssertionError(f"[40] ranks on {a['backend']}, world {a['n_processes']}")
    unequal = [k for k in a["state"] if not torch.equal(a["state"][k], b["state"][k])]
    if unequal or a["losses"] != b["losses"]:
        raise AssertionError(f"[40] the ranks differ: {unequal[:5]}, {a['losses']} {b['losses']}")
    single = dp_run(dp_cfg(str(work / "single")), dev)
    torch.cuda.empty_cache()
    loss_gap = abs(a["losses"][0] - single["losses"][0]) / abs(single["losses"][0])
    worst_state = max(float(((a["state"][k].float() - v.float()).abs()
                             / (5e-3 + 5e-3 * v.float().abs())).max())
                      for k, v in single["state"].items() if v.is_floating_point())

    def rel(x, y):
        return float(np.linalg.norm(x - y) / max(np.linalg.norm(y), 1e-30))

    keys = sorted(single["grads"])
    got = {k: a["grads"][k].double().numpy() for k in keys}
    want = {k: single["grads"][k].double().numpy() for k in keys}

    def flat(d):
        return np.concatenate([d[k].ravel() for k in keys])

    s0, s1 = first_step_spread(dp_cfg(str(work / "spread")), dev)
    rerun = rel(flat(s0), flat(want))  # the same step again: cuDNN's run-to-run gap
    bars = (max(1e-3, 2 * rel(flat(s1), flat(s0))),
            max(1e-3, 2 * max(rel(s1[k], s0[k]) for k in keys)))
    whole = rel(flat(got), flat(want))
    worst = max(rel(got[k], want[k]) for k in keys)
    cos = min(float(np.dot(got[k].ravel(), want[k].ravel())
                    / max(np.linalg.norm(got[k]) * np.linalg.norm(want[k]), 1e-30))
              for k in keys)
    ea, es = a["eval"], single["eval"]
    score_err = float(np.abs(ea["ps"] - es["ps"]).max())
    log(f"  two ranks (gloo, one card): losses {a['losses']}, step s per rank "
        f"{[round(s, 4) for s in a['step_s']]}, {[round(s, 4) for s in b['step_s']]}; one "
        f"process: losses {single['losses']}, step s {[round(s, 4) for s in single['step_s']]}")
    log(f"  the one-process first step run again: its gradients {rerun:.2e} from the first "
        f"run's; with the rows permuted {rel(flat(s1), flat(s0)):.2e}")
    log(f"  ranks vs one process: first loss {loss_gap:.2e} relative; state after two steps "
        f"at {worst_state:.3f} of the 5e-3 bar; first step's gradients {whole:.2e} over all "
        f"(bar {bars[0]:.2e}), worst tensor {worst:.2e} (bar {bars[1]:.2e}), min cosine "
        f"{cos:.6f}; eval sv {ea['sv'] == es['sv']}, labels {np.array_equal(ea['t'], es['t'])}, "
        f"acc {ea['acc']} vs {es['acc']}, max|dscore| {score_err:.2e}")
    # The gradient bars are [25]'s: twice the card's own float32 spread (the
    # one-process gradient with the batch rows permuted), at least 1e-3.
    if (loss_gap > 1e-5 or worst_state > 1.0 or whole > bars[0] or worst > bars[1]
            or cos < 0.999 or ea["sv"] != es["sv"] or not np.array_equal(ea["t"], es["t"])
            or ea["acc"] != es["acc"] or score_err > SCORE_ATOL):
        raise AssertionError("[40] the two ranks do not match the one-process run")
    run_workers("nccl", str(work), 1)
    n = torch.load(work / "nccl_rank0.pt", weights_only=False)
    if n["backend"] != "nccl" or not np.isfinite(n["losses"]).all():
        raise AssertionError(f"[40] the NCCL rank: {n['backend']}, {n['losses']}")
    log(f"  one NCCL rank (world size 1): losses {n['losses']}, step s "
        f"{[round(s, 4) for s in n['step_s']]} at batch 8")
    shutil.rmtree(work, ignore_errors=True)
    return {"gloo_step_s": a["step_s"], "single_step_s": single["step_s"],
            "nccl_step_s": n["step_s"], "first_loss_gap": loss_gap,
            "grad_gap": [whole, worst, cos], "grad_bars": list(bars), "rerun_gap": rerun,
            "score_err": score_err}


def train_parallel_full_width(root: str):
    """[41] ``python -m video_classification_tpu_torch train-parallel
    slowfast-HTAH slowfast-Torso`` at full width (bf16, batch 16, 16
    synthetic videos: one epoch of one step and its eval; DEBUG writes no
    checkpoint, so a real epoch of one batch instead), both
    streams in threads on the one card, against ``train`` of each stream in
    sequence: the wall times, and each stream's checkpoints within the
    train bars of the sequential run's; then conv3d_temporal_sharded over
    two gloo ranks at a res4 conv_a's full-width shape against the
    unsharded convolution (TF32 off)."""
    import torch
    from pathlib import Path

    work = Path(tempfile.mkdtemp(prefix="streams_", dir=root))
    opts = ["--opts", "CHALEARN.BATCH_SIZE", "16", "MODEL.MAX_EPOCH", "1",
            "DATA.SYNTHETIC_NUM_VIDEOS", "16", "DATA.SYNTHETIC_SEQ_LEN", "20"]
    names = ["slowfast-HTAH", "slowfast-Torso"]

    def cli(*argv):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "video_classification_tpu_torch", *argv],
                             cwd=Path(__file__).resolve().parent, capture_output=True,
                             text=True, timeout=WORKER_TIMEOUT_S)
        if out.returncode != 0:
            raise AssertionError(f"{argv[:3]} exited {out.returncode}: {out.stderr[-3000:]}")
        return out.stdout, time.perf_counter() - t0

    torch.cuda.empty_cache()
    said, par_s = cli("train-parallel", *names, "--root", str(work / "par"), *opts)
    seq_s = 0.0
    for name in names:  # a root each: no stream warm-starts from another's checkpoint
        seq_s += cli("train", name, "--root", str(work / "seq" / name), *opts)[1]
    log(f"  train-parallel {' '.join(names)}: {par_s:.2f} s wall; sequential train of each: "
        f"{seq_s:.2f} s in all; " + "; ".join(
            line for line in said.splitlines() if line.startswith("stream ")))
    if "using HTAH checkpoint" in said:
        raise AssertionError("[41] a train-parallel stream warm-started from another's save")
    worst = {}
    for name in names:  # the final save of each run (epoch 0)
        par = sorted((work / "par" / "logs" / "checkpoints" / name).glob("*_e0.ckpt"))
        seq = sorted((work / "seq" / name / "logs" / "checkpoints" / name).glob("*_e0.ckpt"))
        if len(par) != 1 or len(seq) != 1:
            raise AssertionError(f"[41] {name}: final checkpoints {par} vs {seq}")
        a, b = torch.load(par[0]), torch.load(seq[0])
        worst[name] = max(float(((a[k] - v).abs() / (5e-3 + 5e-3 * v.abs())).max())
                          for k, v in b.items() if v.is_floating_point())
    log(f"  each stream's final checkpoint against its sequential run, as a share of the "
        f"atol = rtol = 5e-3 bar: {json.dumps(worst)}")
    if max(worst.values()) > 1.0:
        raise AssertionError("[41] train-parallel's checkpoints differ from the sequential runs")
    shutil.rmtree(work, ignore_errors=True)
    work = Path(tempfile.mkdtemp(prefix="temporal_", dir=root))
    run_workers("temporal", str(work), 2)
    t = [torch.load(work / f"temporal_rank{r}.pt") for r in range(2)]
    shutil.rmtree(work, ignore_errors=True)
    return {"parallel_s": par_s, "sequential_s": seq_s, "ckpt_bar_share": worst,
            "temporal": t[0]}


def queued_ms(fn, reps: int = 20) -> float:
    """Device time of one fn() alone: reps calls queued behind a sleeping
    kernel, so the host's launch rate leaves no gaps between them, timed by
    CUDA events around the calls."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_box_head_nms(serving_calls):
    """[7] K3 on the box head's captured call (20 x 64 boxes, 8 slots, 0.5)
    alone on the device, beside the host-paced time of [5] and the bound."""
    from video_classification_tpu_torch.detect.nms import nms, nms_reference

    (boxes, scores, max_out, thr), = [c for c in serving_calls if c[1].shape[1] == 64]
    ki, km = nms_reference(boxes, scores, max_out, thr)
    ms = queued_ms(lambda: nms(boxes, scores, max_out, thr))
    host_ms = cuda_ms(lambda: nms(boxes, scores, max_out, thr), reps=20)
    bsz, n = scores.shape
    bound_ms, bound_by = bound(nms_scan_ops(scores, ki, km), bsz * n * 20 + bsz * max_out * 5)
    row = {"batch": f"{bsz}x{n}", "max_out": max_out, "thr": thr, "device_ms": round(ms, 5),
           "host_paced_ms": round(host_ms, 5), "bound_ms": bound_ms, "bound_by": bound_by}
    log(f"  K3 box-head call alone on the device: {json.dumps(row)}")
    return row


# -- checkpoints the JAX package writes ---------------------------------------------


def write_jax_files(root: str, model, fusion):
    """The files the JAX package's save_checkpoint and SparseTrainer.save_ckpt
    write, from the port's models through torch_to_flax and the port's flax
    msgpack codec: <root>/logs/checkpoints/slowfast-HTAH/acc0.500_e1.ckpt
    and <root>/logs/sparse_fusion_ckpt/acc-0.500-epoch-1. Returns the
    stream file's path, MB and seconds to convert and write."""
    from pathlib import Path

    from video_classification_tpu_torch.models import torch_to_flax
    from video_classification_tpu_torch.utils import flax_msgpack

    t0 = time.perf_counter()
    ckpt = Path(root, "logs", "checkpoints", "slowfast-HTAH", "acc0.500_e1.ckpt")
    ckpt.parent.mkdir(parents=True)
    ckpt.write_bytes(flax_msgpack.to_bytes(torch_to_flax(model.state_dict(), "slowfast")))
    write_s = time.perf_counter() - t0
    fusion_file = Path(root, "logs", "sparse_fusion_ckpt", "acc-0.500-epoch-1")
    fusion_file.parent.mkdir(parents=True)
    fusion_file.write_bytes(flax_msgpack.to_bytes(
        torch_to_flax(fusion.state_dict(), "sparse")["params"]))
    return ckpt, ckpt.stat().st_size / 1e6, write_s


def serve_from_jax_files(dev, root: str, videos, kernels, ens_counts):
    """[42] slowfast-HTAH (depth 50, 249 classes, CropHTAH 192, CLIP_LEN 20,
    seeded) and a seeded SparseModel (249 x 5) written as the JAX package's
    flax msgpack files at its default paths; (a) a Predictor on that root
    restores tier 1 and serves one 130-frame 240x320 request, its scores
    bit-equal to a Predictor given the same weights directly; (b) an
    EnsemblePredictor over the five part streams (HTAH tier 1, the other
    four tier 2 from the HTAH file, the fusion from its msgpack file) serves
    the three videos of [21], its probabilities bit-equal to the ensemble
    given the same weights directly, K1 and K2 launched as in [21]."""
    from pathlib import Path

    import numpy as np
    import torch

    from video_classification_tpu_torch.engine import EnsemblePredictor, ModelManager, Predictor
    from video_classification_tpu_torch.engine.checkpoint import read_state_dict
    from video_classification_tpu_torch.engine.sparse import PART_YAMLS
    from video_classification_tpu_torch.models import SparseModel

    cfg = htah_cfg(root)
    model = ModelManager(cfg, dev).init_model()
    fusion = SparseModel(249, len(PART_YAMLS), generator=torch.Generator().manual_seed(42))
    ckpt, mb, write_s = write_jax_files(root, model, fusion)
    t0 = time.perf_counter()
    restored = read_state_dict(ckpt)
    read_s = time.perf_counter() - t0
    direct = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    if restored.keys() != direct.keys() or not all(
            torch.equal(restored[k], direct[k]) for k in direct):
        raise AssertionError("[42] the JAX-format file does not read back to the weights")
    log(f"  {ckpt}: {mb:.3f} MB, written in {write_s:.3f} s (torch_to_flax + to_bytes), "
        f"read in {read_s:.3f} s (from_bytes + flax_to_torch); equal to the weights")

    rgb, depth = videos[0]
    from_file = Predictor(cfg, device=dev)
    given = Predictor(htah_cfg(str(Path(root).parent / "no_checkpoints")), device=dev,
                      state_dict=direct)
    got, want = (p.predict_frames(rgb, depth)["probs"] for p in (from_file, given))
    if got.shape != (249,) or not np.array_equal(got, want):
        raise AssertionError(f"[42] Predictor from the JAX file: max diff "
                             f"{np.abs(got - want).max()}")
    log(f"  (a) Predictor restored tier 1 from the JAX file: scores bit-equal, top-1 "
        f"{int(np.argmax(got)) + 1}")
    del from_file, given

    fusion_params = {k: v.detach().numpy() for k, v in fusion.state_dict().items()}
    ens = EnsemblePredictor(cfg_overrides=["CHALEARN.ROOT", root], device=dev)
    ref = EnsemblePredictor(cfg_overrides=["CHALEARN.ROOT", str(Path(root).parent /
                                                                 "no_checkpoints")],
                            device=dev, fusion_params=fusion_params)
    for p in ref.predictors:
        p.model.load_state_dict(direct)
    for k in kernels:
        k.launches = 0
    got = [ens.predict_frames(r, d)["probs"] for r, d in videos]
    counts = {k.__name__: k.launches for k in kernels}
    want = [ref.predict_frames(r, d)["probs"] for r, d in videos]
    if ens.fusion_source != str(Path(root, "logs", "sparse_fusion_ckpt", "acc-0.500-epoch-1")):
        raise AssertionError(f"[42] the fusion came from {ens.fusion_source}")
    if not all(np.array_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("[42] the ensemble from the JAX files differs: max diff "
                             f"{max(float(np.abs(g - w).max()) for g, w in zip(got, want))}")
    for k in kernels:
        if counts[k.__name__] != ens_counts[k.__name__]:
            raise AssertionError(f"[42] {k.__name__}: {counts[k.__name__]} launches, "
                                 f"[21] {ens_counts[k.__name__]}")
    log(f"  (b) EnsemblePredictor from the JAX files ({len(videos)} requests): probabilities "
        f"bit-equal; launches {json.dumps(counts)} as in [21]")
    return {"stream_file_mb": round(mb, 3), "write_s": round(write_s, 3),
            "read_s": round(read_s, 3), "launches": counts}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from pathlib import Path

    from video_classification_tpu_torch.utils.cuda import HEADERS, SOURCES, build

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
    kernel_sources = [k for k in SOURCES if k.endswith(".cu")]
    log(f"[2] built the {len(kernel_sources)} kernels of utils/cuda.SOURCES "
        f"({', '.join(kernel_sources)}; headers {', '.join(HEADERS)}; "
        f"torch.utils.cpp_extension.load) in {time.perf_counter() - t0:.2f} s")

    from video_classification_tpu_torch.detect.nms import nms
    from video_classification_tpu_torch.ops.component_extents import component_extents
    from video_classification_tpu_torch.ops.flow import FlowParams
    from video_classification_tpu_torch.ops.flow_level import flow_level
    from video_classification_tpu_torch.ops.label_components import label_components
    from video_classification_tpu_torch.ops.sor_solve import sor_solve
    from video_classification_tpu_torch.ops.warp import warp_bilinear

    pyramids = flow_pyramids(dev)
    log("[3] K1 flow_level vs plain")
    k1 = check_flow_level(dev, pyramids)
    log("[4] K2 component_extents vs plain (the DensePose detector's serving masks "
        "from one full-width detector run)")
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
    k2 = check_component_extents(dev, dets.charts)

    log("[5] K3 nms vs plain (the serving batches of the same detector run)")
    k3 = check_nms(dev, calls)

    per_op = (sor_solve, warp_bilinear, label_components)
    log("[6] serving slowfast-HTAH at full width, synthetic detector")
    synth_counts, synth_lat, _ = serve_full_width(
        dev, root, videos, (flow_level, component_extents), absent=per_op)
    log("[7] serving slowfast-HTAH at full width, DensePose detector")
    counts, latencies, seen = serve_full_width(
        dev, root, videos, (flow_level, component_extents, nms), detector=detector,
        absent=per_op)
    check_detections(seen, (480, 640))
    k3_box_head = time_box_head_nms(calls)
    log("[8] small serve: card vs cpu")
    serve_small_against_cpu(dev, root)
    log("[9] small DensePose-detector serve: card vs cpu")
    serve_small_detector_against_cpu(dev, root)

    log("[10] K4 sor_solve vs plain")
    k4 = check_sor_solve(dev, pyramids)
    log("[11] K5 warp_bilinear vs plain")
    k5 = check_warp(dev, pyramids)
    del pyramids
    log("[12] K6 label_components vs plain")
    k6 = check_label_components(dev)
    log("[13] per-op flow path on the card vs the checked-in goldens")
    goldens = check_goldens(dev)
    log("[14] serving slowfast-HTAH at full width, synthetic detector, per-op flow")
    op_counts, op_lat, _ = serve_full_width(
        dev, root, videos, (sor_solve, warp_bilinear, component_extents),
        flow_params=FlowParams(fuse_level="off"), absent=(flow_level, label_components))
    log("[15] small serve on the per-op flow path: card vs cpu")
    serve_small_against_cpu(dev, root, fuse_level="off")
    serve_small_against_cpu(dev, root, n_inner=2)

    train_root = tempfile.mkdtemp(prefix="train_", dir=Path(root).parent)
    try:
        log("[16] training slowfast-HTAH at full width on synthetic clips")
        # A checkpoint root per phase: a later Trainer must not restore an
        # earlier phase's checkpoint through tier 1 or 2.
        roots = {p: str(Path(train_root) / p) for p in ("full", "online", "small")}
        trainer, step_s, step_batch = train_full_width(dev, roots["full"])
        log("[17] checkpoint round trip: tier 1 into a fresh Trainer, tier 3")
        checkpoint_round_trip(dev, trainer, roots["full"])
        del trainer
        torch.cuda.empty_cache()
        log("[18] train and eval at full width from the online backend")
        online_videos = synthetic_videos(6)
        train_counts = train_online(dev, roots["online"], online_videos,
                                    (flow_level, component_extents),
                                    (nms, sor_solve, warp_bilinear, label_components))
        log("[19] small train step: card vs cpu")
        train_small_against_cpu(dev, roots["small"])
    finally:
        shutil.rmtree(train_root, ignore_errors=True)
    log("[20] a malformed input to each binding raises a Python exception")
    binding_errors()

    ens_root = tempfile.mkdtemp(prefix="ensemble_", dir=Path(root).parent)
    try:
        roots = {p: str(Path(ens_root) / p) for p in ("ensemble", "small", "sparse", "res3d",
                                                       "res2d", "small_res3d", "small_res2d")}
        log("[21] the five-stream ensemble at full width: ResultSaver, SparseTrainer, "
            "EnsemblePredictor")
        ens_counts, ens_lat = ensemble_full_width(
            dev, roots["ensemble"], videos, (flow_level, component_extents),
            (nms, *per_op), synth_counts)
        log("[22] small ensemble: card vs cpu")
        ensemble_small_against_cpu(dev, roots["small"])
        log("[23] SparseTrainer at full size (35,878 x 5 x 249)")
        sparse_epoch_ms, sparse_test_ms, sparse_projected = sparse_full_size(dev, roots["sparse"])
        res = {}
        for name in ("res3d", "res2d"):
            log(f"[24] {name} trained at full width on synthetic clips, then served")
            res[name] = train_res_full_width(dev, roots[name], name, videos,
                                             (flow_level, component_extents), (nms, *per_op))
        for name in ("res3d", "res2d"):
            log(f"[25] small {name} train step: card vs cpu")
            train_small_against_cpu(dev, roots[f"small_{name}"], name, card_spread=True)
        log("[26] the CLI on the card: sparse-train on [21]'s materials, tools how-many-classes")
        cli_on_card(roots["ensemble"], [i % 249 + 1 for i in range(8)])
        log("[42] serving from the JAX package's checkpoint files (flax msgpack) at full "
            "width: Predictor, then the five-stream ensemble")
        jax_files = serve_from_jax_files(dev, str(Path(ens_root) / "jax_files"), videos,
                                         (flow_level, component_extents), ens_counts)
    finally:
        shutil.rmtree(ens_root, ignore_errors=True)

    offline_root = tempfile.mkdtemp(prefix="offline_", dir=Path(root).parent)
    try:
        log("[27] the provider's resizes on the card vs the cpu and vs this machine's cv2; "
            "frame I/O")
        resizes_cv2 = check_resizes_and_io(dev, offline_root)
        log("[28] the offline chain at full width (ArrayFrameIO, synthetic provider)")
        chain_root, chain_counts28, chain_s, k1_calls = offline_chain_full_width(
            dev, offline_root)
        log("[29] IUV and crops at full width with DensePoseIUVProvider")
        iuv_counts, iuv_s, k3_calls, k2_calls = offline_densepose_full_width(dev, chain_root)
        log("[30] K1, K3 and K2 on the offline chain's calls")
        offline = check_offline_kernels(dev, k1_calls, k3_calls, k2_calls)
        del k1_calls, k3_calls, k2_calls
        torch.cuda.empty_cache()
        log("[31] the small chain and provider: card vs cpu")
        offline_small_against_cpu(dev, offline_root)
    finally:
        shutil.rmtree(offline_root, ignore_errors=True)
    offline_videos = len(OFFLINE_SETS)

    v2_root = tempfile.mkdtemp(prefix="v2_", dir=Path(root).parent)
    try:
        log("[32] RAFT raft_large at full width (64 pairs of 240x320, 12 iterations)")
        raft = raft_full_width(dev, v2_root, videos[0][0])
        log("[33] RAFT small: card vs cpu")
        raft_bar = raft_against_cpu(dev, v2_root, videos[0][0])
        log("[34] v2-convert at full width (ArrayFrameIO): variational + synthetic, "
            "variational + DensePose, RAFT + synthetic")
        v2_chain_root, v2_counts, v2_s, v2_k2 = v2_convert_full_width(dev, v2_root)
        log("[35] V2Trainer at full width, then an epoch and eval on [34]'s folders")
        v2_step_s, v2_batch, v2_peak = v2_train_full_width(dev, v2_chain_root)
        torch.cuda.empty_cache()
        log("[36] the small v2 chain, dataset, trainer and render-iuv: card vs cpu")
        v2_small_against_cpu(dev, v2_root)
    finally:
        shutil.rmtree(v2_root, ignore_errors=True)
    v2_videos = len(OFFLINE_SETS)

    del detector
    torch.cuda.empty_cache()
    par_root = tempfile.mkdtemp(prefix="parallel_", dir=Path(root).parent)
    try:
        log("[37] the native clip loader: codecs on this machine; DATA.BACKEND auto at "
            "full width")
        native = native_loader_full_width(dev, str(Path(par_root) / "native"))
        log("[38] K3 past N = 8192 (the device-memory route) vs plain")
        k3_big = nms_past_8192(dev)
        log("[39] remat at full width (bf16): none, '' and 'conv' at batch 16; the 'conv' "
            "ladder")
        remat = remat_full_width(dev, str(Path(par_root) / "remat"))
        log("[40] data parallel at full width: two gloo ranks on the card vs one process; "
            "one NCCL rank")
        dp = data_parallel_full_width(dev, par_root)
        log("[41] train-parallel slowfast-HTAH slowfast-Torso at full width; the temporal "
            "halo exchange")
        streams = train_parallel_full_width(par_root)
    finally:
        shutil.rmtree(par_root, ignore_errors=True)

    def entry(name, source, replaces, launches, k, library_ms=None):
        row = {"name": name, "route": "cuda",
               "source": f"video_classification_tpu_torch/csrc/{source}",
               "replaces": f"video_classification_tpu/{replaces}",
               "launches": launches,
               "launches_per_online_train_step": train_counts[name],
               "launches_per_ensemble_request": ens_counts[name] / len(ens_lat),
               "launches_per_offline_video":
                   (chain_counts28[name] + iuv_counts[name]) / offline_videos,
               "launches_per_v2_video": v2_counts[name] / v2_videos,
               "max_abs_err": k["max_abs_err"],
               "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
               "bound_by": k["bound_by"], "library_ms": library_ms}
        if name in offline:
            row["offline"] = offline[name]
        if name == "component_extents":
            row["v2"] = v2_k2
        if name == "nms":
            row["past_8192"] = k3_big
            row["box_head_alone"] = k3_box_head
        return row

    kernels = [
        entry("flow_level", "flow_level.cu", "ops/pallas_flow.py:320",
              counts["flow_level"], k1),
        entry("component_extents", "component_extents.cu",
              "ops/pallas_components.py:70", counts["component_extents"], k2),
        entry("nms", "nms.cu", "detect/pallas_nms.py:28", counts["nms"], k3),
        entry("sor_solve", "sor_solve.cu", "ops/pallas_flow.py:53",
              op_counts["sor_solve"], k4),
        entry("warp_bilinear", "warp.cu", "ops/pallas_flow.py:129",
              op_counts["warp_bilinear"], k5, k5["library_ms"]),
        entry("label_components", "label_components.cu",
              "ops/pallas_components.py:50", op_counts["label_components"], k6),
    ]
    log(f"done in {time.perf_counter() - t_start:.1f} s; K2 iterations "
        f"{k2['iters']}, K6 rounds {k6['rounds']}; synthetic-detector launches "
        f"{json.dumps(synth_counts)}, request seconds {[round(x, 3) for x in synth_lat]}; "
        f"DensePose-detector request seconds {[round(x, 3) for x in latencies]}; "
        f"per-op launches {json.dumps(op_counts)}, request seconds "
        f"{[round(x, 3) for x in op_lat]}; goldens {json.dumps(goldens)}; full-width "
        f"train step {step_s * 1e3:.3f} ms at batch {step_batch} "
        f"({step_batch / step_s:.3f} clips/s); ensemble request seconds "
        f"{[round(x, 3) for x in ens_lat]}; offline chain stage seconds "
        f"{json.dumps(chain_s)}, DensePose IUV and crops {json.dumps(iuv_s)}; "
        f"sparse fusion {sparse_epoch_ms:.3f} ms per "
        f"epoch, test {sparse_test_ms:.3f} ms, 2000 epochs {sparse_projected:.2f} s; "
        + "; ".join(f"{n} train step {r[0] * 1e3:.3f} ms at batch {r[1]} "
                    f"({r[1] / r[0]:.3f} clips/s, {r[2] / 2**30:.3f} GiB), request seconds "
                    f"{[round(x, 3) for x in r[4]]}" for n, r in res.items())
        + f"; RAFT full width {json.dumps(raft)}, card vs cpu bar {raft_bar}; v2-convert "
        f"seconds per video {json.dumps(v2_s)}; V2Trainer {v2_step_s * 1e3:.3f} ms per step "
        f"at batch {v2_batch} ({v2_batch / v2_step_s:.3f} clips/s, "
        f"{v2_peak / 2**30:.3f} GiB); native loader {json.dumps(native)}; remat "
        f"{json.dumps(remat)}; data parallel {json.dumps(dp)}; train-parallel and temporal "
        f"{json.dumps(streams)}; JAX checkpoint files {json.dumps(jax_files)}; resizes "
        f"against cv2 {json.dumps(resizes_cv2)}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--worker":
        sys.exit(worker(sys.argv[2], sys.argv[3]))
    sys.exit(main())
