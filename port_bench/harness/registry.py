"""Where the benchmark finds its pieces, by the names in ``BENCHMARK.json``.

  * ``BENCHMARK.json`` (the checkout's root): the cells, the configuration
    and traffic each names, and the metrics each reports;
  * ``port_bench/configs/<config>.json``: a configuration as it is run, whose
    ``"model"`` key names its model plug-in;
  * ``port_bench/models/<model>.py``: a model plug-in: the program under
    test built from seeded weights, each request's or step's work, what the
    check captures of the timed path, the reference's check and the faults
    (``kinds/*.py`` say what each kind asks of it);
  * ``port_bench/traffic/<mix>.json``: a traffic mix's parameters, whose
    ``"kind"`` names its driver;
  * ``port_bench/kinds/<kind>.py``: a kind's driver, ``run(ctx) -> Record``:
    set-up, warm-up, the measured window, the traced passes, the check;
  * ``port_bench/cells/<cell>.json``: a cell's correctness check (the
    sample it compares and the limit of each number);
  * ``port_bench/metrics/<metric>.py``: a metric's reader, ``read(run)``.

A cell, configuration, model, mix, kind or metric is added by adding its
files and its entry in ``BENCHMARK.json``; nothing here names one. A name
whose file is missing raises, naming the file looked for.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

PACKAGE = Path(__file__).resolve().parent.parent
_LOADED: Dict[Path, ModuleType] = {}     # kind, model and reader files by their path


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
        return self._module("metrics", metric)

    def kind(self, name: str) -> ModuleType:
        """The driver of traffic kind ``name``."""
        return self._module("kinds", name)

    def model(self, name: str) -> ModuleType:
        """Model plug-in ``name`` (a plug-in may build on another's)."""
        return self._module("models", name)

    def model_of(self, config: str) -> ModuleType:
        """The model plug-in that configuration ``config`` names."""
        name = self.config(config).get("model")
        if name is None:
            raise ValueError(f"configuration {config!r} names no model: its file "
                             f"{self.package / 'configs' / (config + '.json')} needs "
                             f"\"model\": \"<name>\" for {self.package / 'models'}/<name>.py")
        return self.model(name)

    def _module(self, sub: str, name: str) -> ModuleType:
        """The file ``<sub>/<name>.py``, loaded once a process: every lookup
        of one file gives the same module, and so the same module state."""
        path = (self.package / sub / f"{name}.py").resolve()
        if path in _LOADED:
            return _LOADED[path]
        if not path.is_file():
            raise FileNotFoundError(f"no {sub[:-1]} {name!r}: {path} is missing")
        module_name = f"port_bench_{sub}_{name.replace('.', '_')}"
        spec = importlib.util.spec_from_file_location(module_name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[module_name] = module     # dataclasses look a class's module up there
        spec.loader.exec_module(module)
        _LOADED[path] = module
        return module
