"""Profiling: named ranges on the profiler's timeline (``span``, ``stage``)
and counts of the work done (``count``), wall time per named stage
synchronised with the device (``StageTimer``), step statistics
(``StepTimer``) and a device trace (``trace``).

``span`` and ``count`` act only while a ``torch.profiler`` session records:
the session is their one switch. A span is a ``record_function`` range, so
it lands in the same timeline as the device's kernels and copies, on one
clock; with no session it is one shared no-op context, and costs a flag
read. The names in use: ``serve::request`` (args: the predictor's request
ordinal) and ``serve::stream`` (args: the stream's model name) in
``engine/predictor``; ``stage::<name>`` for the stages (``stage``, and
``stage::upload`` and ``stage::fuse``), and inside ``stage::detect`` the
DensePose detector's ``stage::detect_backbone|detect_rpn|detect_box|
detect_chart`` (``detect/densepose.DensePoseRCNN.forward``);
``kernel::<wrapper>`` around each hand-written kernel's launch (or, on the
CPU, its plain version); ``data::wait`` in
``data/pipeline.prefetch_to_device``; ``train::<phase>`` in
``engine/trainer``. The counts: ``flow.pairs``, the frame pairs
``ops/flow.coarse2fine_flow`` solves; ``flow.sor_resident_levels`` and
``flow.sor_tiled_levels``, the fused levels by their SOR's schedule
(``ops/flow_level``); ``detect.frames``, the frames
``pipeline/online.DensePoseOnlineDetector`` detects."""

from __future__ import annotations

import time
from collections import Counter, defaultdict
from contextlib import contextmanager, nullcontext
from pathlib import Path
from typing import List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

# What ``count`` added while a profiler recorded, by name.
COUNTS: Counter = Counter()
_OFF = nullcontext()


def span(name: str, args: Optional[str] = None):
    """``with span("stage::flow"): ...``: a ``record_function`` range while a
    ``torch.profiler`` session records, else a shared no-op context."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name, args)
    return _OFF


def count(name: str, n: int) -> None:
    """Add ``n`` to ``COUNTS[name]`` while a profiler records."""
    if _autograd_profiler._is_profiler_enabled:
        COUNTS[name] += int(n)


def stage(timer, name: str):
    """``with stage(timer, "flow"): ...``: the span ``stage::<name>`` and,
    when ``timer`` (a ``StageTimer``) is given, the stage's synchronised wall
    time under ``name``."""
    if timer is None:
        return span("stage::" + name)
    return _timed_stage(timer, name)


@contextmanager
def _timed_stage(timer, name: str):
    with timer(name), span("stage::" + name):
        yield


class StageTimer:
    """``with timer("flow"): ...`` adds the stage's wall time to
    ``timer.seconds["flow"]``. On a CUDA device it synchronises at both ends,
    so a stage's time includes the kernels it queued."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.seconds = defaultdict(float)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def __call__(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.seconds[name] += time.perf_counter() - t0


@contextmanager
def trace(logdir):
    """``with trace('logs/profile') as prof: run_steps()``: a
    ``torch.profiler`` trace of the CPU and, where there is one, the card,
    written as a Chrome trace (``trace.json``) into ``logdir``."""
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(logdir / "trace.json"))


class StepTimer:
    """``with timer: step()`` records each step's wall time; ``times``,
    ``mean`` and ``throughput`` leave out the first ``warmup`` steps. The
    caller synchronises the device inside the step if its time should
    include the device's work."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._all: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._all.append(time.perf_counter() - self._t0)
        return False

    @property
    def times(self) -> List[float]:
        return self._all[self.warmup:]

    @property
    def mean(self) -> float:
        ts = self.times
        return sum(ts) / len(ts) if ts else float("nan")

    def throughput(self, items_per_step: int) -> float:
        return items_per_step / self.mean if self.times else float("nan")
