"""Where the benchmark finds its pieces, by the names in ``BENCHMARK.json``.

  * ``BENCHMARK.json`` (the checkout's root): the cells, the configuration
    and traffic each names, and the metrics each reports;
  * ``port_bench/configs/<config>.json``: a configuration as it is run;
  * ``port_bench/traffic/<mix>.json``: a traffic mix's parameters;
  * ``port_bench/cells/<cell>.json``: a cell's correctness check (the
    sample it compares and the limit of each number);
  * ``port_bench/metrics/<metric>.py``: a metric's reader, ``read(run)``.

A cell, configuration, mix or metric is added by adding its files and its
entry in ``BENCHMARK.json``; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

PACKAGE = Path(__file__).resolve().parent.parent


def _read(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


class Registry:
    """The pieces under ``package`` (default ``port_bench/``) and the
    benchmark file ``benchmark`` (default ``BENCHMARK.json`` beside it)."""

    def __init__(self, package: Path = PACKAGE, benchmark: Optional[Path] = None):
        self.package = Path(package)
        self.benchmark = _read(Path(benchmark) if benchmark else self.package.parent / "BENCHMARK.json")

    def workload(self, name: str) -> Dict:
        for w in self.benchmark["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        return _read(self.package / "configs" / f"{name}.json")

    def traffic(self, name: str) -> Dict:
        return _read(self.package / "traffic" / f"{name}.json")

    def cell(self, name: str) -> Dict:
        return _read(self.package / "cells" / f"{name}.json")

    def metrics(self, workload: str, traced: bool) -> List[Dict]:
        """The metrics a run of ``workload`` reports: its end-to-end ones
        untraced, its per-layer ones traced (those without a ``workloads``
        list in every cell that reports the end-to-end metric they move)."""
        e2e = [m for m in self.benchmark["end_to_end"]
               if workload in m.get("workloads", [workload])]
        if not traced:
            return e2e
        reported = {m["name"] for m in e2e}
        return [m for m in self.benchmark["per_layer"]
                if (workload in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]

    def reader(self, metric: str) -> ModuleType:
        path = self.package / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"port_bench_metric_{metric}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
