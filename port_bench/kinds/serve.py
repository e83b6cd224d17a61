"""Serving cells: one closed-loop client's requests of whole videos through
the program that the configuration's model plug-in builds.

Set-up makes the mix's videos from the seed, draws the videos the check
samples, and has the plug-in make the check's slots and build the program
from seeded weights; then it serves one request of each length in the mix,
so every shape the window meets has run once. The window then serves one
client's requests back to back, each timed on the host from the call to its
answer, until ``seconds`` have passed and the last cycle of the mix is
whole; each sampled video's last request is kept for the check. A traced
run then serves one more cycle with the program's stage timers on (stage
seconds per request) and a few requests under the profiler. Last, once the
program is freed, the plug-in's check: its reference serves the sampled
videos again and the answers are compared.

What this driver asks of the plug-in, ``ctx.model.serve(ctx)`` (made before
the traffic: the program's configuration is loaded there):

  * ``prepare(traffic, sample)``: what the window's work counts need, and
    the check's slots on the device, made before the peak is reset;
  * ``build()``: the program from seeded weights, ``ctx.fault`` planted in
    it and the check's capture installed;
  * ``capturing(key)``: the request served next is ``key``'s, for the
    capture, or None (warm-up and traced requests);
  * ``predict(rgb, depth)``: the timed call, returning the answer;
  * ``work(length)``: (bf16 FLOP, float32 op) of a request of ``length``
    raw frames;
  * ``keep(key, out)``: a sampled video's request answered ``out``;
  * ``stages(call)``: ``call()`` with the program's stage timers on, and
    their seconds by stage;
  * ``capture_bytes``: the slots' device memory, left out of the peak;
  * ``free()``: the capture removed and the program freed;
  * ``check(rec, traffic, sample)``: the numbers compared into
    ``rec.numbers``, with ``rec.check_s``, ``rec.sampled`` and notes.
"""

from __future__ import annotations

import random
import time
from typing import Dict, List, Tuple

import torch

from port_bench.harness import trace
from port_bench.harness.core import Context, Record
from port_bench.harness.traffic import ServeTraffic


def sample_keys(traffic: ServeTraffic, seed: int, n: int) -> List[Tuple[int, int]]:
    """The ``n`` videos (keys) whose requests the check compares, drawn from
    the seed, one of the longest first."""
    pick = random.Random(int(seed) * 104729 + 17)
    longest = max(k[0] for k in traffic.keys)
    first = pick.choice([k for k in traffic.keys if k[0] == longest])
    rest = [k for k in traffic.keys if k != first]
    return [first] + pick.sample(rest, min(len(rest), n - 1))


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def run(ctx: Context) -> Record:
    # One CPU thread: the intra-op pool's threads otherwise compete with the
    # client's host work for the machine's shared cores, and the rate spreads.
    torch.set_num_threads(1)
    dev, mix = ctx.device, ctx.mix
    model = ctx.model.serve(ctx)
    ctx.mark("port imports")
    traffic = ServeTraffic(mix, ctx.seed, dev)
    rec = Record()
    ctx.mark("traffic")
    sample = sample_keys(traffic, ctx.seed, int(ctx.cell["check"]["requests"]))

    if ctx.mode != "control":
        model.prepare(traffic, sample)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        try:
            model.build()

            def serve(key, timed=False):
                rgb, depth = traffic.videos[key]
                model.capturing(key if timed else None)
                t0 = time.perf_counter()
                out = model.predict(rgb, depth)
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
                rec.work.append(model.work(key[0]))
                if key in sample:
                    model.keep(key, out)
                if (time.perf_counter() - t_start >= ctx.seconds
                        and rec.attempted % traffic.cycle == 0):
                    break
            rec.window_s = time.perf_counter() - t_start
            rec.done = len(rec.latencies)
            rec.notes["window"] = _window_notes(rec.latencies, ends, rec.window_s)
            if ctx.trace:
                _traced_passes(ctx, rec, traffic, requests, model, serve)
            rec.memory_peak_bytes = ctx.memory_peak() - model.capture_bytes
        finally:
            model.free()
    else:
        rec.setup_s = time.perf_counter() - ctx.t_start

    model.check(rec, traffic, sample)
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


def _traced_passes(ctx, rec, traffic, requests, model, serve) -> None:
    """One cycle with the program's stage timers on (stage seconds per
    request), then ``trace_requests`` requests under the profiler."""
    for _ in range(traffic.cycle):
        key = next(requests)
        rec.stages.append(model.stages(lambda: serve(key)))
        rec.stage_work.append(model.work(key[0]))
    keys = [next(requests) for _ in range(int(ctx.mix["trace_requests"]))]
    rec.timeline = trace.traced(lambda: [serve(k) for k in keys], ctx.out_dir, ctx.device)
