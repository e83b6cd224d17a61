"""The program's own spans and counts in a traced run, for the metric readers.

The port opens ``record_function`` ranges while a profiler records
(``utils/profiling.span``), so they lie in the traced sub-window's Chrome
trace beside the device's operations, on one clock. ``of(run)`` reduces the
trace ``harness/trace.traced`` wrote (``port_bench/.out/trace.json``) to one
entry per span name whose prefix is in ``PREFIXES``:

  * ``n``: the spans of that name;
  * ``host_s``: their summed durations;
  * ``device_s``: the device seconds of the kernels, copies and memsets
    launched while a span of that name was open;
  * ``launches``: the count of those operations;
  * ``kernel_s``: the part of ``device_s`` launched inside a ``kernel::``
    span too (the port's own kernels).

A device operation is tied to its launch by its correlation id (the
``cuda_runtime`` or ``cuda_driver`` call that queued it, also for the port's
extension, whose launches are no aten op), and credited to every span on the
launching thread that encloses the launch, each name once. The file is read
only where the run traced and its busy seconds and top operations are those
of ``run.timeline``: a trace left by another run reads as none.

``counts()`` is the program's ``utils/profiling.COUNTS``, what ``count``
added while a profiler recorded: in a run of ``port_bench.run``, its traced
sub-window. A program without spans or counts gives none, and the readers
then return None.

A reader divides by the trace's own count of ``serve::request`` spans
(``requests(run)``) or by ``run.trace_steps``.
"""

from __future__ import annotations

import json
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .trace import DEVICE_CATS, WINDOW, reduce_trace

TRACE = Path(__file__).resolve().parent.parent / ".out" / "trace.json"
PREFIXES = ("serve::", "stage::", "kernel::", "data::", "train::")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PROGRAM = "video_classification_tpu_torch.utils.profiling"

_cache: Dict[tuple, Optional[Dict]] = {}


def reduce_spans(events) -> Dict[str, Dict[str, float]]:
    """The entries above from Chrome-trace ``events`` (times in
    microseconds)."""
    spans = defaultdict(list)            # thread -> [(start, end, name)]
    launches = {}                        # correlation id -> (thread, time)
    device = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat == "user_annotation" and e["name"].startswith(PREFIXES):
            spans[e.get("tid")].append((e["ts"], e["ts"] + e.get("dur", 0), e["name"]))
        elif cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (e.get("tid"), e["ts"])
        elif cat in DEVICE_CATS:
            device.append(e)
    out: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"n": 0, "host_s": 0.0, "device_s": 0.0, "launches": 0, "kernel_s": 0.0})
    ops = defaultdict(list)              # thread -> [(launch time, device seconds)]
    for e in device:
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is not None:
            ops[launch[0]].append((launch[1], e.get("dur", 0) / 1e6))
    for tid, ss in spans.items():
        ss.sort()
        for a, b, name in ss:
            out[name]["n"] += 1
            out[name]["host_s"] += (b - a) / 1e6
        active: List[Tuple[float, float, str]] = []
        nxt = 0
        for t, dur in sorted(ops.get(tid, ())):
            while nxt < len(ss) and ss[nxt][0] <= t:
                active.append(ss[nxt])
                nxt += 1
            active = [x for x in active if x[1] >= t]
            names = {x[2] for x in active}
            in_kernel = any(n.startswith("kernel::") for n in names)
            for name in names:
                out[name]["device_s"] += dur
                out[name]["launches"] += 1
                if in_kernel:
                    out[name]["kernel_s"] += dur
    return dict(out)


def of(run) -> Optional[Dict[str, Dict[str, float]]]:
    """``reduce_spans`` of ``run``'s traced sub-window, or None."""
    t = run.timeline
    if t is None or not TRACE.is_file():
        return None
    st = TRACE.stat()
    key = (str(TRACE), st.st_mtime_ns, st.st_size, t.busy_s)
    if key not in _cache:
        _cache.clear()
        _cache[key] = _read(t)
    return _cache[key]


def _read(timeline) -> Optional[Dict[str, Dict[str, float]]]:
    with open(TRACE) as f:
        events = json.load(f)["traceEvents"]
    marks = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not marks:
        return None
    busy_s, ops, _ = reduce_trace(events, (marks[0]["ts"], marks[0]["ts"] + marks[0]["dur"]))
    if busy_s != timeline.busy_s or ops != timeline.device_ops:
        return None
    return reduce_spans(events)


def requests(run) -> int:
    """The ``serve::request`` spans of ``run``'s trace (0 without one)."""
    s = of(run)
    return int(s["serve::request"]["n"]) if s and "serve::request" in s else 0


def per_request(run, name: str, field: str) -> Optional[float]:
    """``field`` of span ``name`` over the trace's requests, or None."""
    s = of(run)
    n = requests(run)
    if not n or name not in s:
        return None
    return s[name][field] / n


def counts() -> Optional[Dict[str, int]]:
    """The program's ``COUNTS``, or None where it keeps none."""
    module = sys.modules.get(PROGRAM)
    c = getattr(module, "COUNTS", None)
    return dict(c) if c is not None else None
