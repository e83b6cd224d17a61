"""Serving cells: closed-loop requests of whole videos through the program's
``engine/predictor.Predictor.predict_frames`` (one stream) or
``EnsemblePredictor.predict_frames`` (the streams fused).

Set-up makes the mix's videos and every stream's weights from the seed,
draws the videos the check samples, makes the device slots their flow
images are kept in (``Capture``), builds the predictor, loads the weights
through ``load_state_dict`` (and the fusion's through ``fusion_params``),
and serves one request of each length in the mix, so every clip count the
window meets has run once. The window then serves one client's requests
back to back, each timed on the host from the call to its probabilities,
until ``seconds`` have passed and the last cycle of the mix is whole; each
sampled video's last request keeps its answer, clip scores and flow images.
A traced run then serves one more cycle with the program's ``StageTimer`` on
(stage seconds per request) and a few requests under the profiler. Last,
once the program is freed, the check: the reference (``reference.serve``)
serves the sampled videos again, and their answers are compared clip by
clip and class by class, and their flow images pixel by pixel.
"""

from __future__ import annotations

import gc
import math
import random
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..counts import flops, flow_ops
from ..reference import serve as ref
from ..reference.flow import BF16, FlowParams, F32
from ..reference.precision import FP8, strict_float32
from ..reference.slowfast import FLOAT32, SlowFast
from . import check, weights
from .core import Context, Record, stream_cfgs, stream_seed
from .trace import traced
from .traffic import ServeTraffic


def _build(ctx: Context, cfgs, names):
    from video_classification_tpu_torch.engine.predictor import EnsemblePredictor, Predictor

    dev = ctx.device
    classes, depth = int(cfgs[0].CHALEARN.NUM_CLASS), int(cfgs[0].MODEL.DEPTH)
    states = [weights.stream_state_dict(classes, depth, stream_seed(ctx.seed, i), dev)
              for i in range(len(names))]
    if len(names) == 1:
        pred = Predictor(cfgs[0], device=dev, state_dict=states[0])
        streams = {names[0]: pred}
    else:
        fusion = weights.fusion_params(classes, len(names), stream_seed(ctx.seed, -1), dev)
        pred = EnsemblePredictor(names, cfg_overrides=ctx.overrides(), device=dev,
                                 fusion_params={k: v.cpu().numpy() for k, v in fusion.items()})
        streams = dict(zip(pred.part_yamls, pred.predictors))
        for p, sd in zip(pred.predictors, states):
            p.model.load_state_dict(sd)
    del states
    return pred, streams


def sample_keys(traffic: ServeTraffic, seed: int, n: int) -> List[Tuple[int, int]]:
    """The ``n`` videos (keys) whose requests the check compares, drawn from
    the seed, one of the longest first."""
    pick = random.Random(int(seed) * 104729 + 17)
    longest = max(k[0] for k in traffic.keys)
    first = pick.choice([k for k in traffic.keys if k[0] == longest])
    rest = [k for k in traffic.keys if k != first]
    return [first] + pick.sample(rest, min(len(rest), n - 1))


class Capture:
    """What the check reads of the timed path, kept as the path makes it:
    each stream's per-clip scores of the request in flight (its
    ``clip_scores_frames``, which ``predict_frames`` calls) and, for the
    sampled videos, every window's flow images (``device_pipeline
    .video_flow_uint8``, which the crops stage calls once a window), copied
    on the device into slots made in set-up. A sampled video's slots hold
    its last request of the window. ``bytes`` is the slots' device memory."""

    def __init__(self, sample, windows: Dict, names, shape, device):
        from video_classification_tpu_torch.pipeline import device_pipeline

        self.module = device_pipeline
        self.saved = device_pipeline.video_flow_uint8
        self.slots = {(key, name, w): None for key in sample for name in names
                      for w in range(windows[key])}
        self.slots = {k: i for i, k in enumerate(self.slots)}
        cuda = torch.device(device).type == "cuda"
        before = torch.cuda.memory_allocated(device) if cuda else 0
        self.flows = torch.zeros((len(self.slots), *shape), dtype=torch.uint8, device=device)
        self.bytes = (torch.cuda.memory_allocated(device) - before) if cuda else 0
        self.key = self.stream = None
        self.window = 0
        self.scores: Dict[str, np.ndarray] = {}

    def install(self, streams: Dict) -> None:
        flow = self.module.video_flow_uint8

        def video_flow_uint8(frames, *args, **kwargs):
            out = flow(frames, *args, **kwargs)
            slot = self.slots.get((self.key, self.stream, self.window))
            if slot is not None:
                self.flows[slot].copy_(out)
            self.window += 1
            return out

        self.module.video_flow_uint8 = video_flow_uint8
        for name, p in streams.items():
            def scores(rgb, depth=None, _orig=p.clip_scores_frames, _name=name):
                self.stream, self.window = _name, 0
                out = _orig(rgb, depth)
                self.scores[_name] = out
                return out
            p.clip_scores_frames = scores

    def remove(self) -> None:
        self.module.video_flow_uint8 = self.saved


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def run(ctx: Context) -> Record:
    # One CPU thread: the intra-op pool's threads otherwise compete with the
    # client's host work for the machine's shared cores, and the rate spreads.
    torch.set_num_threads(1)
    dev, mix = ctx.device, ctx.mix
    names = list(ctx.config["streams"])
    cfgs = stream_cfgs(ctx, names)
    interval = int(cfgs[0].CHALEARN.IMG_SAMPLE_INTERVAL)
    clip_len = int(cfgs[0].CHALEARN.CLIP_LEN)
    ctx.mark("port imports")
    traffic = ServeTraffic(mix, ctx.seed, dev)
    rec = Record()
    ctx.mark("traffic")
    per_clip = sum(flops.clip_flops(int(c.CHALEARN.NUM_CLASS), int(c.MODEL.DEPTH), clip_len,
                                    flops.crop_size(c.MODEL.R3D_INPUT)) for c in cfgs)
    fp = FlowParams(**ctx.config["flow"])
    sample = sample_keys(traffic, ctx.seed, int(ctx.cell["check"]["requests"]))

    def work(length: int):
        windows = ref.window_indices(length, clip_len, interval)
        pairs = {(int(w[j - 1]), int(w[j])) for w in windows for j in range(1, len(w))}
        moving = sum(1 for a, b in pairs if a != b)
        return (len(windows) * per_clip,
                moving * flow_ops.pair_ops(mix["height"], mix["width"], fp))

    served: Dict = {}       # sampled key -> its last request's answer
    cap = None
    if ctx.mode != "control":
        windows = {k: len(ref.window_indices(k[0], clip_len, interval)) for k in sample}
        cap = Capture(sample, windows, names,
                      (clip_len * interval + 1, mix["height"], mix["width"], 3), dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        pred, streams = _build(ctx, cfgs, names)
        ctx.mark("predictor")
        try:
            if ctx.fault is not None:
                ctx.fault(pred, streams)
            cap.install(streams)

            def serve(key, timed=False):
                rgb, depth = traffic.videos[key]
                cap.key = key if timed else None
                t0 = time.perf_counter()
                out = pred.predict_frames(rgb, depth)
                return time.perf_counter() - t0, out

            for n in sorted(set(traffic.lengths)):      # every clip count of the mix
                serve((n, 0))
            _sync(dev)
            ctx.mark("warm-up")
            rec.setup_s = time.perf_counter() - ctx.t_start
            requests = traffic.requests()
            ends: List[float] = []
            t_start = time.perf_counter()
            while True:
                key = next(requests)
                rec.attempted += 1
                try:
                    lat, out = serve(key, timed=True)
                except RuntimeError as e:  # a failed request: counted, not timed
                    rec.failed += 1
                    rec.errors.append(repr(e))
                    continue
                rec.latencies.append(lat)
                ends.append(time.perf_counter() - t_start)
                rec.work.append(work(key[0]))
                if key in sample:
                    served[key] = {"probs": out["probs"], "clips": dict(cap.scores)}
                if (time.perf_counter() - t_start >= ctx.seconds
                        and rec.attempted % traffic.cycle == 0):
                    break
            rec.window_s = time.perf_counter() - t_start
            rec.done = len(rec.latencies)
            rec.notes["window"] = _window_notes(rec.latencies, ends, rec.window_s)
            if ctx.trace:
                _traced_passes(ctx, rec, traffic, requests, streams, serve, work)
            rec.memory_peak_bytes = ctx.memory_peak() - cap.bytes
        finally:
            cap.remove()
        del pred, streams
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    else:
        rec.setup_s = time.perf_counter() - ctx.t_start

    _check(ctx, rec, traffic, cfgs, names, sample, served, cap, clip_len, interval, fp)
    return rec


def _window_notes(latencies: List[float], ends: List[float], window_s: float) -> Dict:
    """Where a window's time went, for reading its spread: the fastest,
    median and slowest request, and the requests done in each quarter of the
    window over that quarter's seconds."""
    if not latencies:
        return {}
    quarter = window_s / 4
    counts = [0] * 4
    for t in ends:
        counts[min(3, int(t / quarter))] += 1
    lat = sorted(latencies)
    return {"lat_min": round(lat[0], 5), "lat_median": round(lat[len(lat) // 2], 5),
            "lat_max": round(lat[-1], 5),
            "quarter_rates": [round(c / quarter, 3) for c in counts]}


def _traced_passes(ctx, rec, traffic, requests, streams, serve, work) -> None:
    """One cycle with the program's ``StageTimer`` on (stage seconds per
    request), then ``trace_requests`` requests under the profiler."""
    from video_classification_tpu_torch.utils.profiling import StageTimer

    for _ in range(traffic.cycle):
        for p in streams.values():
            p.timer = StageTimer(ctx.device)
        key = next(requests)
        serve(key)
        rec.stage_work.append(work(key[0]))
        total: Dict[str, float] = {}
        for p in streams.values():
            for k, v in p.timer.seconds.items():
                total[k] = total.get(k, 0.0) + v
        rec.stages.append(total)
    for p in streams.values():
        p.timer = None
    keys = [next(requests) for _ in range(int(ctx.mix["trace_requests"]))]
    rec.timeline = traced(lambda: [serve(k) for k in keys], ctx.out_dir, ctx.device)


def _check(ctx, rec, traffic, cfgs, names, sample, served, cap, clip_len, interval, fp) -> None:
    """The sampled requests served again by the reference, once the program
    is freed: per-clip and per-video probabilities, the fusion, and every
    window's flow images. The control puts the reference in the program's
    place, its flow held in bfloat16 and its networks in fp8."""
    dev = ctx.device
    classes, depth = int(cfgs[0].CHALEARN.NUM_CLASS), int(cfgs[0].MODEL.DEPTH)
    folders = [c.MODEL.R3D_INPUT for c in cfgs]
    order = sorted(range(len(names)), key=lambda i: names[i])
    models = []
    for i in range(len(names)):
        m = SlowFast(classes, depth).to(dev)
        m.load_state_dict(weights.stream_state_dict(classes, depth, stream_seed(ctx.seed, i), dev))
        models.append(m)
    fusion = (weights.fusion_params(classes, len(names), stream_seed(ctx.seed, -1), dev)
              if len(names) > 1 else None)
    spent = rec.notes.setdefault("check_s", {"networks": 0.0})

    def clips_of(key, quant, flows):
        rgb, depth_frames = traffic.videos[key]
        return ref.video_clips(torch.from_numpy(rgb).to(dev),
                               torch.from_numpy(depth_frames).to(dev), folders, clip_len,
                               interval, fp, spent, flows, quant)

    def probs(clips, quant):
        t = time.perf_counter()
        per = {}
        for i, m in enumerate(models):
            m.set_quant(quant)
            per[names[i]] = ref.clip_probs(m, clips[folders[i]]).cpu()
            m.set_quant(FLOAT32)
        spent["networks"] += time.perf_counter() - t
        return per

    def fused(per, dtype=torch.float32):
        return ref.fuse([per[names[i]] for i in order], fusion["weight"].cpu(),
                        fusion["bias"].cpu(), dtype)

    pairs: Dict[str, list] = {"logp_gap": []}
    if fusion is not None:
        pairs["fused_gap"], pairs["fused_e2e_gap"] = [], []
    flow_pairs = []
    missing = False
    t0 = time.perf_counter()
    with strict_float32():
        for key in sample:
            if ctx.mode != "control" and key not in served:
                missing = True
                continue
            flows: List[torch.Tensor] = []
            want = probs(clips_of(key, F32, flows), FLOAT32)
            if ctx.mode == "control":
                theirs: List[torch.Tensor] = []
                got = probs(clips_of(key, BF16, theirs), FP8)
                video = fused(got, torch.bfloat16) if fusion is not None else got[names[0]].mean(0)
                flow_pairs += list(zip(theirs, flows))
            else:
                got = {n: torch.as_tensor(np.asarray(served[key]["clips"][n])) for n in names}
                video = torch.as_tensor(np.asarray(served[key]["probs"]))
                flow_pairs += [(cap.flows[cap.slots[(key, n, w)]][1:], f)
                               for n in names for w, f in enumerate(flows)]
            for name in names:
                pairs["logp_gap"].append((got[name], want[name]))
                pairs["logp_gap"].append((got[name].mean(0), want[name].mean(0)))
            if fusion is None:
                pairs["logp_gap"].append((video, want[names[0]].mean(0)))
            else:
                # The fusion is judged on the streams' own scores (judged above).
                pairs["fused_gap"].append((video, fused(got)))
                pairs["fused_e2e_gap"].append((video, fused(want)))
    rec.check_s = time.perf_counter() - t0
    rec.numbers = check.serve_numbers(pairs)
    rec.numbers["flow_off"] = check.flow_off(flow_pairs)
    if missing:     # a sampled video that no request of the window answered
        rec.numbers["logp_gap"] = math.inf
    rec.sampled = len(sample)
