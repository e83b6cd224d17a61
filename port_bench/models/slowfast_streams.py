"""slowfast_streams: SlowFast part streams behind the variational flow and
the synthetic detector, one (``Predictor``, ``Trainer``) or several fused
per class (``EnsemblePredictor``), as the configuration's ``streams`` list
them.

Serving (``serve``): the program is ``engine/predictor.Predictor
.predict_frames`` or ``EnsemblePredictor.predict_frames``; each stream's
weights go in through ``load_state_dict`` (the fusion's through
``fusion_params``). A request's work is its clips' network FLOPs
(``counts/flops.py``, the reference SlowFast) and its moving frame pairs'
flow operations (``counts/flow_ops.py``, K1's count). The check's capture
(``Capture``) keeps each stream's clip scores and every window's flow
images of the sampled videos' last requests; the check serves them again
through the reference (``reference.serve``) and compares the answers clip
by clip and class by class (``logp_gap``, ``fused_gap``, ``clips_off``) and
the flow images pixel by pixel (``flow_off``).

Training (``train``): the program is ``engine/trainer.Trainer.train_step``
fed by ``data/dataset.train_batches`` through ``data/pipeline
.prefetch_to_device``. The parameters are copied before the check's steps,
the first step's gradient is read back from Adam's first moment (m = (1 -
beta1) g after one step) and the parameters again after the last; the check
runs the reference (``reference.train``) on the same rows and compares the
losses, the first gradient and the change (``grad_gap``, ``update_gap``).

The control puts the reference in the program's place one precision down:
its flow held in bfloat16, its networks in fp8, the fusion in bfloat16.

Weights are seeded and made on the device in a few large calls. A stream's
state dict follows the reference network's names and shapes
(``reference.slowfast.SlowFast`` built on the meta device): convolution and
linear weights N(0, 1 / fan_in) (the program's own initialisation; He's
2 / fan_in drives the logits to ~1e4), the head's bias 0, BatchNorm's scale
U(0.5, 1.5), shift N(0, 0.1), running mean N(0, 0.1) and running variance
U(0.5, 1.5), so that every statistic of eval-mode BatchNorm is exercised.
Every value comes from one ``torch.Generator`` on the device seeded with
the stream's seed: the same seed gives the same weights.

``FAULTS`` holds, by kind, the faults the tests and ``calibrate.py`` plant
in the program; each takes what ``build`` made (serving: the predictor and
its streams; training: the trainer) and breaks it in place.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from port_bench.counts import flops, flow_ops
from port_bench.harness import check
from port_bench.harness.core import OUT_DIR, Context, Record
from port_bench.reference import serve as ref
from port_bench.reference.flow import BF16, F32, FlowParams
from port_bench.reference.precision import FP8, strict_float32
from port_bench.reference.slowfast import FLOAT32, SlowFast
from port_bench.reference.train import BETAS, train_steps


NO_ROOT = OUT_DIR / "no_root"   # never created: no checkpoint is found there


# ---- the streams' configurations --------------------------------------------

def overrides(ctx: Context) -> List[str]:
    """The configuration's ``opts`` as the program's command-line overrides,
    with no dataset root and the run's seed."""
    opts = dict(ctx.config["opts"], **{"CHALEARN.ROOT": str(NO_ROOT), "CUDA.SEED": int(ctx.seed)})
    return [x for k, v in opts.items() for x in (k, str(v))]


def stream_seed(seed: int, index: int) -> int:
    return (int(seed) * 31 + index + 7) % (2 ** 63)


def stream_cfgs(ctx: Context, names):
    """Each stream's program configuration, refused where a key reads other
    than the configuration's ``opts`` state."""
    from video_classification_tpu_torch.config import load_model_cfg

    cfgs = [load_model_cfg(n, overrides=overrides(ctx)) for n in names]
    for cfg in cfgs:
        for key, want in ctx.config["opts"].items():
            node = cfg
            for part in key.split("."):
                node = getattr(node, part) if not isinstance(node, dict) else node[part]
            if str(node) != str(want):
                raise ValueError(f"{key} reads {node!r}, the configuration states {want!r}")
    return cfgs


# ---- weights ----------------------------------------------------------------

def _kinds(model: torch.nn.Module):
    """(name, shape, kind) of every parameter and buffer, in state-dict order."""
    for name, t in model.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        if t.dim() >= 2:
            kind = "weight"
        elif ".proj." in name or name.startswith("proj."):
            kind = "zero"
        else:
            kind = {"weight": "scale", "bias": "shift", "running_mean": "shift",
                    "running_var": "scale"}[leaf]
        yield name, tuple(t.shape), kind


def stream_state_dict(classes: int, depth: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of one stream's SlowFast, float32 on ``device``."""
    with torch.device("meta"):
        layout = list(_kinds(SlowFast(classes, depth)))
    g = torch.Generator(device).manual_seed(int(seed))
    sizes = {k: sum(math.prod(s) for _, s, kind in layout if kind == k)
             for k in ("weight", "scale", "shift")}
    pools = {"weight": torch.randn(sizes["weight"], generator=g, device=device),
             "scale": torch.rand(sizes["scale"], generator=g, device=device) + 0.5,
             "shift": torch.randn(sizes["shift"], generator=g, device=device) * 0.1}
    at = {k: 0 for k in pools}
    out = {}
    for name, shape, kind in layout:
        if kind == "zero":
            out[name] = torch.zeros(shape, device=device)
            continue
        n = math.prod(shape)
        t = pools[kind][at[kind]:at[kind] + n].view(shape)
        at[kind] += n
        if kind == "weight":
            t = t * math.sqrt(1.0 / math.prod(shape[1:]))
        out[name] = t
    return out


def fusion_params(classes: int, parts: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """The sparse fusion's {'weight' (C, P), 'bias' (C,)}, drawn as the
    ChaLearn reference's ``SparseModel`` initialises its per-class
    ``nn.Linear(P, 1)`` (train_sparse.py:95-104, PyTorch's default): weight
    and bias U(-1/sqrt(P), 1/sqrt(P))."""
    g = torch.Generator(device).manual_seed(int(seed))
    bound = 1.0 / math.sqrt(parts)
    wb = (torch.rand((classes, parts + 1), generator=g, device=device) * 2.0 - 1.0) * bound
    return {"weight": wb[:, :parts].contiguous(), "bias": wb[:, parts].contiguous()}


# ---- serving ----------------------------------------------------------------

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


class Serving:
    """The serving kind's plug-in (``kinds/serve.py`` lists what it asks)."""

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.names = list(ctx.config["streams"])
        self.cfgs = stream_cfgs(ctx, self.names)
        self.interval = int(self.cfgs[0].CHALEARN.IMG_SAMPLE_INTERVAL)
        self.clip_len = int(self.cfgs[0].CHALEARN.CLIP_LEN)
        self.classes = int(self.cfgs[0].CHALEARN.NUM_CLASS)
        self.depth = int(self.cfgs[0].MODEL.DEPTH)
        self.fp = FlowParams(**ctx.config["flow"])
        self.served: Dict = {}      # sampled key -> its last request's answer
        self.cap = None
        self.pred = self.streams = None
        self.capture_bytes = 0

    def prepare(self, traffic, sample) -> None:
        self.mix = self.ctx.mix
        self.per_clip = sum(flops.clip_flops(int(c.CHALEARN.NUM_CLASS), int(c.MODEL.DEPTH),
                                             self.clip_len, flops.crop_size(c.MODEL.R3D_INPUT))
                            for c in self.cfgs)
        self.ctx.mark("flop count")
        windows = {k: len(ref.window_indices(k[0], self.clip_len, self.interval)) for k in sample}
        self.cap = Capture(sample, windows, self.names,
                           (self.clip_len * self.interval + 1, self.mix["height"],
                            self.mix["width"], 3), self.ctx.device)
        self.capture_bytes = self.cap.bytes

    def work(self, length: int):
        windows = ref.window_indices(length, self.clip_len, self.interval)
        pairs = {(int(w[j - 1]), int(w[j])) for w in windows for j in range(1, len(w))}
        moving = sum(1 for a, b in pairs if a != b)
        return (len(windows) * self.per_clip,
                moving * flow_ops.pair_ops(self.mix["height"], self.mix["width"], self.fp))

    def build(self) -> None:
        from video_classification_tpu_torch.engine.predictor import EnsemblePredictor, Predictor

        ctx, dev, names = self.ctx, self.ctx.device, self.names
        states = [stream_state_dict(self.classes, self.depth, stream_seed(ctx.seed, i), dev)
                  for i in range(len(names))]
        if len(names) == 1:
            self.pred = Predictor(self.cfgs[0], device=dev, state_dict=states[0])
            self.streams = {names[0]: self.pred}
        else:
            fusion = fusion_params(self.classes, len(names), stream_seed(ctx.seed, -1), dev)
            self.pred = EnsemblePredictor(
                names, cfg_overrides=overrides(ctx), device=dev,
                fusion_params={k: v.cpu().numpy() for k, v in fusion.items()})
            self.streams = dict(zip(self.pred.part_yamls, self.pred.predictors))
            for p, sd in zip(self.pred.predictors, states):
                p.model.load_state_dict(sd)
        del states
        ctx.mark("predictor")
        if ctx.fault is not None:
            ctx.fault(self.pred, self.streams)
        self.cap.install(self.streams)
        self.predict = self.pred.predict_frames

    def capturing(self, key) -> None:
        self.cap.key = key

    def keep(self, key, out) -> None:
        self.served[key] = {"probs": out["probs"], "clips": dict(self.cap.scores)}

    def stages(self, call) -> Dict[str, float]:
        from video_classification_tpu_torch.utils.profiling import StageTimer

        for p in self.streams.values():
            p.timer = StageTimer(self.ctx.device)
        call()
        total: Dict[str, float] = {}
        for p in self.streams.values():
            for k, v in p.timer.seconds.items():
                total[k] = total.get(k, 0.0) + v
            p.timer = None
        return total

    def free(self) -> None:
        if self.cap is not None:
            self.cap.remove()
        self.pred = self.streams = self.predict = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, rec: Record, traffic, sample) -> None:
        """The sampled requests served again by the reference, once the
        program is freed: per-clip and per-video probabilities, the fusion,
        and every window's flow images. The control puts the reference in
        the program's place, its flow held in bfloat16 and its networks in
        fp8."""
        ctx, names, cap, served = self.ctx, self.names, self.cap, self.served
        dev, fp, clip_len, interval = ctx.device, self.fp, self.clip_len, self.interval
        classes, depth = self.classes, self.depth
        folders = [c.MODEL.R3D_INPUT for c in self.cfgs]
        order = sorted(range(len(names)), key=lambda i: names[i])
        models = []
        for i in range(len(names)):
            m = SlowFast(classes, depth).to(dev)
            m.load_state_dict(stream_state_dict(classes, depth, stream_seed(ctx.seed, i), dev))
            models.append(m)
        fusion = (fusion_params(classes, len(names), stream_seed(ctx.seed, -1), dev)
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
                    video = (fused(got, torch.bfloat16) if fusion is not None
                             else got[names[0]].mean(0))
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


# ---- training ---------------------------------------------------------------

def _host(tensors):
    return {k: v.detach().float().cpu().clone() for k, v in tensors.items()}


class Training:
    """The training kind's plug-in (``kinds/train.py`` lists what it asks)."""

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.cfg = stream_cfgs(ctx, [ctx.config["streams"][0]])[0]
        cfg = self.cfg
        self.classes, self.depth = int(cfg.CHALEARN.NUM_CLASS), int(cfg.MODEL.DEPTH)
        self.batch, clip_len = int(cfg.CHALEARN.BATCH_SIZE), int(cfg.CHALEARN.CLIP_LEN)
        self.size = flops.crop_size(cfg.MODEL.R3D_INPUT)
        self.clip_shape = (clip_len, self.size, self.size, 21)
        self.step_work = None       # counted in build, under a set-up mark of its own
        self.losses: List[float] = []
        self.grad: Dict[str, torch.Tensor] = {}
        self.delta: Dict[str, torch.Tensor] = {}

    def build(self, stream) -> None:
        from video_classification_tpu_torch.data.dataset import train_batches
        from video_classification_tpu_torch.data.pipeline import prefetch_to_device
        from video_classification_tpu_torch.engine.trainer import Trainer

        ctx, dev = self.ctx, self.ctx.device
        self.step_work = (3 * self.batch * flops.clip_flops(self.classes, self.depth,
                                                            self.clip_shape[0], self.size), 0.0)
        ctx.mark("flop count")
        self.trainer = Trainer(self.cfg, device=dev, dataset_factory=lambda _cfg, _set: stream)
        ctx.mark("trainer")
        self.trainer.model.load_state_dict(
            stream_state_dict(self.classes, self.depth, stream_seed(ctx.seed, 0), dev))
        ctx.mark("weights")
        if ctx.fault is not None:
            ctx.fault(self.trainer)
        self.feed = prefetch_to_device(train_batches(stream, self.batch, seed=ctx.seed), dev,
                                       int(self.cfg.CUDA.PREFETCH_DEPTH))
        self.params = dict(self.trainer.model.named_parameters())
        self.start = _host(self.params)
        ctx.mark("feed")

    def step(self):
        b = next(self.feed)
        return self.trainer.train_step(b["x"], b["label"])

    def keep(self, k: int, out) -> None:
        self.losses.append(float(out["loss"]))
        if k == 0:
            state = self.trainer.optimizer.state
            self.grad = {n: state[p]["exp_avg"].detach().float().cpu() / (1 - BETAS[0])
                         if p in state else torch.zeros(p.shape) for n, p in self.params.items()}

    def keep_change(self) -> None:
        after = _host(self.params)
        self.delta = {k: after[k] - self.start[k] for k in self.start}
        del self.start, after

    def free(self) -> None:
        self.feed.close()
        del self.trainer, self.feed, self.params
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, rec: Record, stream, steps: int) -> None:
        batch = self.batch
        rows = [(torch.from_numpy(stream.clips[k * batch:(k + 1) * batch]),
                 torch.from_numpy(stream.labels[k * batch:(k + 1) * batch]))
                for k in range(steps)]
        prog_loss, prog_grad, prog_delta = self.losses, self.grad, self.delta
        t0 = time.perf_counter()
        lr = float(self.cfg.MODEL.LR)
        with strict_float32():
            want = self._reference(rows, lr, None)
            if self.ctx.mode == "control":
                prog_loss, prog_grad, prog_delta = self._reference(rows, lr, FP8)
        rec.check_s = time.perf_counter() - t0
        rec.numbers = check.train_numbers(prog_loss, want[0], prog_grad, want[1],
                                          prog_delta, want[2])
        leaves = check.moved_leaves(want[1])
        rec.notes = {"losses": [prog_loss, want[0]],
                     "worst_grad": check.worst_leaves(prog_grad, want[1], leaves),
                     "worst_update": check.worst_leaves(prog_delta, want[2], leaves)}

    def _reference(self, rows, lr, quant):
        dev = self.ctx.device
        model = SlowFast(self.classes, self.depth).to(dev)
        model.load_state_dict(stream_state_dict(self.classes, self.depth,
                                                stream_seed(self.ctx.seed, 0), dev))
        if quant is not None:
            model.set_quant(quant)
        out = train_steps(model, rows, self.ctx.seed, lr, self.size)
        end = dict(model.named_parameters())
        delta = {k: (end[k].detach() - out["start"][k]).float().cpu() for k in end}
        grad = {k: g.float().cpu() for k, g in out["grad"].items()}
        losses = out["loss"]
        del model, out, end
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return losses, grad, delta


def serve(ctx: Context) -> Serving:
    return Serving(ctx)


def train(ctx: Context) -> Training:
    return Training(ctx)


# ---- faults -----------------------------------------------------------------

def answer_altered(pred, streams) -> None:
    """Each stream's first clip's scores come out shifted by one class."""
    for p in streams.values():
        def scores(ds, _orig=p._scores):
            out = _orig(ds).copy()
            out[0] = np.roll(out[0], 1)
            return out
        p._scores = scores


def half_clips(pred, streams) -> None:
    """Only the first half of a request's clips is scored (at least one),
    and the video's mean taken over those."""
    for p in streams.values():
        def scores(ds, _orig=p._scores):
            out = _orig(ds)
            return out[:max(1, out.shape[0] // 2)]
        p._scores = scores


def flow_zero(pred, streams) -> None:
    """The flow stage returns the encoding of zero motion."""
    from video_classification_tpu_torch.pipeline import device_pipeline

    def zero_flow(frames, params=None):
        out = torch.zeros(frames.shape[:3] + (3,), dtype=torch.uint8, device=frames.device)
        out[..., :2] = 127
        return out

    device_pipeline.video_flow_uint8 = zero_flow


def _flow_params(change) -> None:
    from video_classification_tpu_torch.pipeline import device_pipeline

    flow = device_pipeline.video_flow_uint8

    def video_flow_uint8(frames, params=None):
        params = params if params is not None else device_pipeline.DEFAULT_PARAMS
        return flow(frames, params._replace(**change(params)))

    device_pipeline.video_flow_uint8 = video_flow_uint8


def flow_outers(pred, streams) -> None:
    """The flow relinearises each level half as often (7 outers: 3)."""
    _flow_params(lambda p: {"n_outer": max(1, p.n_outer // 2)})


def flow_sweeps(pred, streams) -> None:
    """The flow's SOR makes a third of its sweeps (30: 10)."""
    _flow_params(lambda p: {"n_sor": max(1, p.n_sor // 3)})


def half_batch(trainer) -> None:
    """Each step trains on the first half of its batch, the mean over it."""
    step = trainer.train_step

    def train_step(x, labels, *args, **kwargs):
        n = x.shape[0] // 2
        return step(x[:n], labels[:n])

    trainer.train_step = train_step


def unchanged(trainer) -> None:
    """The optimizer's step leaves the parameters as they were."""
    trainer.optimizer.step = lambda *a, **k: None


FAULTS = {"serve": {"answer_altered": answer_altered, "half_clips": half_clips,
                    "flow_zero": flow_zero, "flow_outers": flow_outers,
                    "flow_sweeps": flow_sweeps},
          "train": {"half_batch": half_batch, "unchanged": unchanged}}
