"""Training cells: the train step of the program that the configuration's
model plug-in builds, fed from the mix's pool of distinct in-memory clips.

Set-up makes the pool from the seed and has the plug-in build the program
from seeded weights and open its feed. Its first three steps are the
warm-up and the check's steps: the plug-in keeps what the check compares of
them (the losses, the first gradient, the change over the three). The
window then trains on from the same feed, at most two steps in flight,
until ``seconds`` have passed, and ends on a synchronise. A traced run
profiles a few more steps. Last, once the program is freed, the plug-in's
check: its reference runs the three steps on the same rows.

What this driver asks of the plug-in, ``ctx.model.train(ctx)`` (made before
the pool: the program's configuration is loaded there):

  * ``batch``, ``classes`` and ``clip_shape``: the pool's clips are
    ``clip_shape`` uint8 arrays, labels below ``classes``, ``batch`` a step;
  * ``build(stream)``: the program from seeded weights on ``stream`` (a
    ``ClipStream``), ``ctx.fault`` planted in it, its feed opened;
  * ``step()``: one train step from the feed, returning a mapping with the
    step's ``"loss"``;
  * ``keep(k, out)``: the check's step ``k`` (from 0) returned ``out``;
    ``keep_change()``: the check's steps are done;
  * ``step_work``: (bf16 FLOP, float32 op) of a step, once ``build`` has run;
  * ``free()``: the feed closed and the program freed;
  * ``check(rec, stream, steps)``: the numbers compared into
    ``rec.numbers``, with ``rec.check_s`` and notes.
"""

from __future__ import annotations

import math
import time

import torch

from port_bench.harness import trace
from port_bench.harness.core import Context, Record
from port_bench.harness.traffic import ClipStream

CHECK_STEPS = 3


def run(ctx: Context) -> Record:
    dev, mix = ctx.device, ctx.mix
    model = ctx.model.train(ctx)
    ctx.mark("port imports")
    stream = ClipStream(mix, model.clip_shape, model.classes, ctx.seed, dev)
    ctx.mark("pool")
    rec = Record(clips_per_step=model.batch)
    if len(stream.clips) < CHECK_STEPS * model.batch:
        raise ValueError("the mix's pool must hold the check's steps' rows")

    if ctx.mode != "control":
        model.build(stream)
        for k in range(CHECK_STEPS):
            model.keep(k, model.step())
            ctx.mark(f"step {k + 1}")
        model.keep_change()
        _sync(dev)
        ctx.mark("check copies")
        rec.setup_s = time.perf_counter() - ctx.t_start

        t0 = time.perf_counter()
        pending = None
        while True:
            m = model.step()
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
        rec.work = [model.step_work] * rec.attempted
        if ctx.trace:
            rec.trace_steps = int(mix["trace_steps"])
            rec.timeline = trace.traced(lambda: [model.step() for _ in range(rec.trace_steps)],
                                        ctx.out_dir, dev)
        rec.memory_peak_bytes = ctx.memory_peak()
        del m
        model.free()
    else:
        rec.setup_s = time.perf_counter() - ctx.t_start

    model.check(rec, stream, CHECK_STEPS)
    rec.sampled = CHECK_STEPS
    return rec


def _event(dev):
    if dev.type != "cuda":
        return None
    e = torch.cuda.Event()
    e.record()
    return e


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
