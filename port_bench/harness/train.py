"""Training cells: the program's ``engine/trainer.Trainer.train_step`` fed by
``data/dataset.train_batches`` through ``data/pipeline.prefetch_to_device``.

Set-up makes the mix's pool of distinct clips and the stream's weights from
the seed, builds the ``Trainer`` on the mix's clip stream, loads the weights
through ``load_state_dict``, and opens one feed. Its first three steps are
the warm-up and the check's steps: the parameters are copied before them,
the first step's gradient is read back from Adam's first moment (m = (1 -
beta1) g after one step) and the parameters again after the third. The
window then trains on from the same feed, at most two steps in flight, until
``seconds`` have passed, and ends on a synchronise. A traced run profiles a
few more steps. Last, once the program is freed, the reference
(``reference.train``) runs the three steps on the same rows and the
check compares the losses, the first gradient and the change.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from ..counts import flops
from ..reference.precision import FP8, strict_float32
from ..reference.slowfast import SlowFast
from ..reference.train import BETAS, train_steps
from . import check, weights
from .core import Context, Record, stream_cfgs, stream_seed
from .trace import traced
from .traffic import ClipStream

CHECK_STEPS = 3


def _host(tensors):
    return {k: v.detach().float().cpu().clone() for k, v in tensors.items()}


def run(ctx: Context) -> Record:
    from video_classification_tpu_torch.data.dataset import train_batches
    from video_classification_tpu_torch.data.pipeline import prefetch_to_device
    from video_classification_tpu_torch.engine.trainer import Trainer

    dev, mix = ctx.device, ctx.mix
    name = ctx.config["streams"][0]
    cfg = stream_cfgs(ctx, [name])[0]
    classes, depth = int(cfg.CHALEARN.NUM_CLASS), int(cfg.MODEL.DEPTH)
    batch, clip_len = int(cfg.CHALEARN.BATCH_SIZE), int(cfg.CHALEARN.CLIP_LEN)
    size = flops.crop_size(cfg.MODEL.R3D_INPUT)
    ctx.mark("port imports")
    stream = ClipStream(mix, (clip_len, size, size, 21), classes, ctx.seed, dev)
    ctx.mark("pool")
    rec = Record(clips_per_step=batch)
    step_flops = 3 * batch * flops.clip_flops(classes, depth, clip_len, size)
    rows = [(torch.from_numpy(stream.clips[k * batch:(k + 1) * batch]),
             torch.from_numpy(stream.labels[k * batch:(k + 1) * batch]))
            for k in range(CHECK_STEPS)]
    if len(stream.clips) < CHECK_STEPS * batch:
        raise ValueError("the mix's pool must hold the check's steps' rows")

    prog_loss, prog_grad, prog_delta = [], {}, {}
    if ctx.mode != "control":
        trainer = Trainer(cfg, device=dev, dataset_factory=lambda _cfg, _set: stream)
        ctx.mark("trainer")
        trainer.model.load_state_dict(
            weights.stream_state_dict(classes, depth, stream_seed(ctx.seed, 0), dev))
        ctx.mark("weights")
        if ctx.fault is not None:
            ctx.fault(trainer)
        feed = prefetch_to_device(train_batches(stream, batch, seed=ctx.seed), dev,
                                  int(cfg.CUDA.PREFETCH_DEPTH))
        params = dict(trainer.model.named_parameters())
        start = _host(params)

        def step():
            b = next(feed)
            return trainer.train_step(b["x"], b["label"])

        ctx.mark("feed")
        for k in range(CHECK_STEPS):
            prog_loss.append(float(step()["loss"]))
            ctx.mark(f"step {k + 1}")
            if k == 0:
                state = trainer.optimizer.state
                prog_grad = {n: state[p]["exp_avg"].detach().float().cpu() / (1 - BETAS[0])
                             if p in state else torch.zeros(p.shape) for n, p in params.items()}
        after = _host(params)
        prog_delta = {k: after[k] - start[k] for k in start}
        del start, after
        _sync(dev)
        ctx.mark("check copies")
        rec.setup_s = time.perf_counter() - ctx.t_start

        t0 = time.perf_counter()
        pending = None
        while True:
            m = step()
            rec.attempted += 1
            done = _event(dev)
            if pending is not None:
                pending.synchronize()
            pending = done
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        _sync(dev)
        rec.window_s = time.perf_counter() - t0
        last = float(m["loss"])
        rec.failed = 0 if math.isfinite(last) else 1
        rec.done = rec.attempted
        rec.work = [(step_flops, 0.0)] * rec.attempted
        if ctx.trace:
            rec.trace_steps = int(mix["trace_steps"])
            rec.timeline = traced(lambda: [step() for _ in range(rec.trace_steps)],
                                  ctx.out_dir, dev)
        rec.memory_peak_bytes = ctx.memory_peak()
        feed.close()
        del trainer, feed, params, m
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    else:
        rec.setup_s = time.perf_counter() - ctx.t_start

    t0 = time.perf_counter()
    lr = float(cfg.MODEL.LR)
    with strict_float32():
        ref = _reference(ctx, classes, depth, rows, lr, size, None)
        if ctx.mode == "control":
            prog_loss, prog_grad, prog_delta = _reference(ctx, classes, depth, rows, lr, size, FP8)
    rec.check_s = time.perf_counter() - t0
    rec.numbers = check.train_numbers(prog_loss, ref[0], prog_grad, ref[1], prog_delta, ref[2])
    leaves = check.moved_leaves(ref[1])
    rec.notes = {"losses": [prog_loss, ref[0]],
                 "worst_grad": check.worst_leaves(prog_grad, ref[1], leaves),
                 "worst_update": check.worst_leaves(prog_delta, ref[2], leaves)}
    rec.sampled = CHECK_STEPS
    return rec


def _reference(ctx, classes, depth, rows, lr, size, quant):
    dev = ctx.device
    model = SlowFast(classes, depth).to(dev)
    model.load_state_dict(weights.stream_state_dict(classes, depth, stream_seed(ctx.seed, 0), dev))
    if quant is not None:
        model.set_quant(quant)
    out = train_steps(model, rows, ctx.seed, lr, size)
    end = dict(model.named_parameters())
    delta = {k: (end[k].detach() - out["start"][k]).float().cpu() for k in end}
    grad = {k: g.float().cpu() for k, g in out["grad"].items()}
    losses = out["loss"]
    del model, out, end
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return losses, grad, delta


def _event(dev):
    if dev.type != "cuda":
        return None
    e = torch.cuda.Event()
    e.record()
    return e


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
