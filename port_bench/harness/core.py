"""One run of one cell: set-up, the measured window, the check, the result.

``execute`` runs a cell on a device and returns the result's fields: the
traffic mix's ``kind`` names the driver (``kinds/<kind>.py``), the
configuration's ``model`` the plug-in the driver builds the program with
(``models/<model>.py``).
``main`` is the command line: it refuses to run without the cards the cell
asks for, prints the numbers compared beside their limits as the last lines
of standard error, and the result as the last line of standard output.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .registry import Registry

OUT_DIR = Path(__file__).resolve().parent.parent / ".out"


@dataclass
class Record:
    """What a run measured, for the metric readers (``metrics/*.py``)."""

    setup_s: float = math.nan
    window_s: float = math.nan
    attempted: int = 0
    failed: int = 0
    done: int = 0
    errors: List[str] = field(default_factory=list)
    latencies: List[float] = field(default_factory=list)
    work: List[Tuple[float, float]] = field(default_factory=list)  # (bf16 FLOP, f32 op)
    clips_per_step: int = 0
    stages: List[Dict[str, float]] = field(default_factory=list)
    stage_work: List[Tuple[float, float]] = field(default_factory=list)
    timeline: object = None
    trace_steps: int = 0
    memory_peak_bytes: int = 0
    numbers: Dict[str, float] = field(default_factory=dict)
    check_s: float = math.nan
    sampled: int = 0
    peaks: Dict[str, float] = field(default_factory=dict)
    notes: Dict = field(default_factory=dict)


@dataclass
class Context:
    registry: Registry
    workload: str
    config: Dict
    model: ModuleType              # the configuration's model plug-in
    mix: Dict
    cell: Dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    mode: str = "program"          # "program", or "control": the reference one precision down
    fault: Optional[Callable] = None
    out_dir: Path = OUT_DIR
    marks: Dict[str, float] = field(default_factory=dict)

    def mark(self, step: str) -> None:
        """Note the seconds since the run started at the end of a set-up step."""
        self.marks[step] = round(time.perf_counter() - self.t_start, 3)

    def memory_peak(self) -> int:
        if self.device.type == "cuda":
            return int(torch.cuda.max_memory_allocated(self.device))
        return 0


def execute(registry: Registry, workload: str, seed: int, seconds: float, trace: bool,
            device, t_start: float, mode: str = "program",
            fault: Optional[Callable] = None) -> Dict:
    """The result's fields of one run, and the numbers compared."""
    w = registry.workload(workload)
    mix = registry.traffic(w["traffic"])
    driver = registry.kind(mix["kind"])
    ctx = Context(registry, workload, registry.config(w["config"]), registry.model_of(w["config"]),
                  mix, registry.cell(workload), int(seed), float(seconds), bool(trace),
                  torch.device(device), t_start, mode, fault)
    ctx.mark("imports")
    rec = driver.run(ctx)
    rec.notes["setup_at"] = ctx.marks
    rec.peaks = _read_json(registry.package / "counts" / "peaks.json")
    metrics = {}
    for m in registry.metrics(workload, trace):
        value = registry.reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct, shown = _judge(rec, ctx.cell["limits"])
    result = {"correct": correct, "attempted": rec.attempted, "failed": rec.failed,
              "metrics": metrics, "device": _device(ctx, rec)}
    if trace and rec.timeline is not None:
        result["breakdown"] = {"device_ops": rec.timeline.device_ops,
                               "idle_gaps": rec.timeline.idle_gaps}
    result["check"] = shown
    return {"result": result, "record": rec}


def _judge(rec: Record, limits: Dict[str, float]):
    from .check import judge

    correct, shown = judge(rec.numbers, limits)
    for k in sorted(set(rec.numbers) - set(limits)):    # printed, not compared
        rec.notes.setdefault("not_compared", {})[k] = rec.numbers[k]
    if rec.failed or rec.done == 0:
        correct = False
    shown["failed_requests"] = {"value": rec.failed, "limit": 0}
    return correct, shown


def _read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _device(ctx: Context, rec: Record) -> Dict:
    if ctx.device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(ctx.device), "count": 1}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1}
    dev["memory_peak_bytes"] = rec.memory_peak_bytes
    if ctx.trace and rec.timeline is not None:
        dev["busy_s"] = rec.timeline.busy_s
        dev["window_s"] = rec.timeline.window_s
    return dev


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="One run of one cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(t_start: float, argv=None) -> int:
    from .guard import forbidden_modules

    args = parse(argv)
    registry = Registry()
    chips = int(registry.workload(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = execute(registry, args.workload, args.seed, args.seconds, bool(args.trace),
                  "cuda", t_start)
    found = forbidden_modules()
    if found:
        print(f"port_bench: modules of the JAX package or JAX are loaded: {found}",
              file=sys.stderr)
        return 3
    result, rec = out["result"], out["record"]
    print(f"port_bench: {args.workload} seed {args.seed}: {power_limit()}; "
          f"window {rec.window_s:.3f} s, {rec.done} done, check {rec.check_s:.1f} s "
          f"on {rec.sampled} sampled", file=sys.stderr)
    if rec.notes:
        print(f"port_bench: notes {json.dumps(rec.notes)}", file=sys.stderr)
    for e in rec.errors[:5]:
        print(f"port_bench: failed: {e}", file=sys.stderr)
    for name, v in result["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
