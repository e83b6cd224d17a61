"""Drivers found by traffic kind and models by the configuration's plug-in:
the tiny cells read the numbers they read before the split into kinds and
plug-ins, a new kind and a new model come as files alone, and a name whose
file is missing raises, naming the file."""

import json
import time

import pytest
import torch

from port_bench.harness.core import execute
from port_bench.harness.registry import Registry

from .conftest import PACKAGE, write_tiny

# The tiny cells' check numbers as the harness read them, one CPU thread,
# before its drivers and the SlowFast model were split into kinds/ and models/.
RECORDED = json.loads((PACKAGE / "tests" / "tiny_numbers.json").read_text())

STUB_KIND = '''
"""A kind whose driver asks its model plug-in for one number."""
import time

from port_bench.harness.core import Record


def run(ctx):
    model = ctx.model.echo(ctx)
    rec = Record(attempted=1, done=1)
    rec.setup_s = time.perf_counter() - ctx.t_start
    rec.numbers = model.check()
    return rec
'''

STUB_MODEL = '''
"""A model whose check reads the gap its configuration states."""


class Echo:
    def __init__(self, ctx):
        self.gap = float(ctx.config["gap"])

    def check(self):
        return {"echo_gap": self.gap}


def echo(ctx):
    return Echo(ctx)
'''


@pytest.fixture
def one_thread():
    """One CPU thread, as the numbers were recorded (the training step's sums
    round in another order with more)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("workload,seed", [(w, s) for w in sorted(RECORDED)
                                           for s in sorted(RECORDED[w])])
def test_numbers_as_recorded(tiny_registry, one_thread, workload, seed):
    out = execute(tiny_registry, workload, int(seed), 0.5, False, "cpu", time.perf_counter())
    assert out["record"].numbers == RECORDED[workload][seed]
    assert out["result"]["correct"]


def _stub_tree(tmp_path):
    pkg = tmp_path / "bench"
    bench_file = write_tiny(pkg)
    (pkg / "kinds" / "echo.py").write_text(STUB_KIND)
    (pkg / "models" / "echo_model.py").write_text(STUB_MODEL)
    (pkg / "traffic" / "echo_mix.json").write_text(json.dumps({"kind": "echo"}))
    bench = json.loads(bench_file.read_text())
    for name, gap in (("near", 0.1), ("far", 0.9)):
        (pkg / "configs" / f"{name}.json").write_text(
            json.dumps({"name": name, "model": "echo_model", "gap": gap}))
        (pkg / "cells" / f"echo.{name}.json").write_text(
            json.dumps({"check": {}, "limits": {"echo_gap": 0.5}}))
        bench["workloads"].append({"name": f"echo.{name}", "config": name,
                                   "traffic": "echo_mix", "chips": 1, "why": "t"})
    bench_file.write_text(json.dumps(bench))
    return Registry(pkg, bench_file)


@pytest.mark.parametrize("config,correct", [("near", True), ("far", False)])
def test_new_kind_and_model_by_files_alone(tmp_path, config, correct):
    """A kind file, a model plug-in, a mix, a configuration and a cell
    added as files run through ``execute``; the plug-in's own number is
    judged against the cell's limit."""
    out = execute(_stub_tree(tmp_path), f"echo.{config}", 2**31 + 5, 0.5, False, "cpu",
                  time.perf_counter())
    res = out["result"]
    assert res["check"]["echo_gap"]["limit"] == 0.5
    assert res["correct"] is correct
    assert set(res["metrics"]) == {"setup_s"}


def test_missing_model_key_names_the_file(tmp_path):
    r = _stub_tree(tmp_path)
    (r.package / "configs" / "near.json").write_text(json.dumps({"name": "near", "gap": 0.1}))
    with pytest.raises(ValueError, match=r"near\.json.*\"model\".*models/<name>\.py"):
        execute(r, "echo.near", 1, 0.5, False, "cpu", time.perf_counter())


def test_unknown_model_names_the_file(tmp_path):
    r = _stub_tree(tmp_path)
    (r.package / "configs" / "near.json").write_text(
        json.dumps({"name": "near", "model": "no_such_model", "gap": 0.1}))
    with pytest.raises(FileNotFoundError, match=r"models/no_such_model\.py"):
        execute(r, "echo.near", 1, 0.5, False, "cpu", time.perf_counter())


def test_unknown_kind_names_the_file(tmp_path):
    r = _stub_tree(tmp_path)
    (r.package / "traffic" / "echo_mix.json").write_text(json.dumps({"kind": "no_such_kind"}))
    with pytest.raises(FileNotFoundError, match=r"kinds/no_such_kind\.py"):
        execute(r, "echo.near", 1, 0.5, False, "cpu", time.perf_counter())
