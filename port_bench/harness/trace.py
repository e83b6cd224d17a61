"""A traced sub-window: ``torch.profiler``'s device timeline, reduced.

``traced(fn, out_dir)`` runs ``fn`` under the profiler (host and device
activities), writes the Chrome trace to ``out_dir/trace.json`` and returns
a ``Timeline``:

  * ``window_s``: the host's wall seconds of the traced call (synchronised);
  * ``busy_s``: the union of the device's operation intervals (kernels,
    copies, memsets), so overlapping streams count once;
  * ``device_ops``: seconds by operation name, most first;
  * ``idle_gaps``: the device's idle seconds (between its operations, and
    before the first and after the last within the window) summed by the
    innermost host operation running at each gap's middle: what the host
    was doing while the device waited;
  * ``phases``: device seconds by phase of a train step, the kernel-to-phase
    attribution of the program's ``profile_train.profile`` (frozen here): a
    kernel belongs to the ``train::<phase>`` range around the host op that
    launched it, to 'backward' under an autograd engine op (those run on
    autograd's own thread, outside the ranges), else to 'other'.
"""

from __future__ import annotations

import heapq
import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "port_bench::window"
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")


class Timeline(NamedTuple):
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    phases: Dict[str, float]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _phases(prof) -> Dict[str, float]:
    from torch.autograd import DeviceType

    phases: Dict[str, float] = defaultdict(float)
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        phase, scope = "other", e
        while scope is not None:
            if scope.name.startswith("train::"):
                phase = scope.name.removeprefix("train::")
                break
            if scope.name.startswith("autograd::engine::"):
                phase = "backward"
                break
            scope = scope.cpu_parent
        phases[phase] += sum(k.duration for k in e.kernels) / 1e6
    return dict(phases)


def reduce_trace(events: List[Dict], window: Tuple[float, float]) -> Tuple[float, list, list]:
    """(busy_s, device_ops, idle_gaps) of Chrome-trace ``events`` (times in
    microseconds) within ``window`` (start, end) in the trace's clock."""
    dev = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    host = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    busy = _union([(a, b) for a, b, _ in dev])
    busy_us = sum(b - a for a, b in busy)
    by_name: Dict[str, float] = defaultdict(float)
    for a, b, name in dev:
        by_name[name] += (b - a) / 1e6
    edges = [window[0]] + [x for iv in busy for x in iv] + [window[1]]
    gaps: Dict[str, float] = defaultdict(float)
    host.sort()
    active: List[Tuple[float, float, str]] = []  # (duration, end, name), shortest first
    nxt = 0
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        while nxt < len(host) and host[nxt][0] <= mid:
            s, e, n = host[nxt]
            heapq.heappush(active, (e - s, e, n))
            nxt += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        name = active[0][2] if active else WINDOW
        gaps["host Python, no op" if name == WINDOW else name[:160]] += (b - a) / 1e6
    top = sorted(((n[:160], t) for n, t in by_name.items()), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return busy_us / 1e6, [[n, s] for n, s in top], [[n, s] for n, s in idle]


def traced(fn: Callable[[], None], out_dir: Path, device) -> Timeline:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            t0 = time.perf_counter()
            fn()
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            window_s = time.perf_counter() - t0
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    marks = [e for e in events if e.get("name") == WINDOW
             and e.get("cat") == "user_annotation"]
    mark = marks[0]
    busy_s, ops, gaps = reduce_trace(events, (mark["ts"], mark["ts"] + mark["dur"]))
    return Timeline(window_s, busy_s, ops, gaps, _phases(prof))
