"""The benchmark's files are found by name, and a cell is added by files alone."""

import json
import re
import shutil

import pytest

from port_bench.harness.registry import Registry

from .conftest import PACKAGE, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_cell_pieces_found_by_name(workload):
    r = Registry()
    w = r.workload(workload)
    config, mix, cell = r.config(w["config"]), r.traffic(w["traffic"]), r.cell(workload)
    assert config["name"] == w["config"] and config["streams"]
    assert callable(r.kind(mix["kind"]).run)
    assert callable(getattr(r.model_of(w["config"]), mix["kind"]))
    assert cell["limits"]
    names = [m["name"] for m in r.metrics(workload, False)]
    assert "setup_s" in names and len(names) >= 2
    assert r.metrics(workload, True)


def test_a_plug_in_is_loaded_once():
    """Every lookup of one file gives one module, so that a plug-in's module
    state is not split between copies."""
    assert Registry().model("slowfast_streams") is Registry().model_of("slowfast-HTAH")
    assert Registry().kind("serve") is Registry().kind("serve")
    assert Registry().reader("setup_s") is Registry().reader("setup_s")


@pytest.mark.parametrize("metric", [m["name"] for m in bench()["end_to_end"] + bench()["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(Registry().reader(metric).read)


def test_benchmark_file_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["port_bench"] and 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("port_bench/")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for w in b["workloads"]:
        reported = [m for m in b["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2
        assert any(w["name"] in m.get("workloads", []) for m in b["per_layer"])
    assert len(json.dumps(b)) < 64 * 1024


def test_new_cell_added_by_files_alone(tmp_path):
    """A copy of the benchmark's data with one more cell (its cell file and
    its BENCHMARK.json entry) lists and loads it through the same code."""
    pkg = tmp_path / "port_bench"
    for sub in ("configs", "traffic", "cells", "kinds", "models", "metrics", "counts"):
        shutil.copytree(PACKAGE / sub, pkg / sub, ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    (pkg / "traffic" / "v130.json").write_text(
        json.dumps(dict(json.loads((PACKAGE / "traffic" / "v100.json").read_text()), lengths=[130])))
    b["workloads"].append({"name": "serve.htah.v130", "config": "slowfast-HTAH",
                           "traffic": "v130", "chips": 1, "why": "130-frame videos"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "serve.ensemble5.v100" in m.get("workloads", []):
            m["workloads"].append("serve.htah.v130")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    (pkg / "cells" / "serve.htah.v130.json").write_text(
        json.dumps({"check": {"requests": 3}, "limits": {"logp_gap": 0.5, "clips_off": 0}}))
    r = Registry(pkg)
    w = r.workload("serve.htah.v130")
    assert r.traffic(w["traffic"])["lengths"] == [130]
    assert r.cell("serve.htah.v130")["check"]["requests"] == 3
    assert {m["name"] for m in r.metrics("serve.htah.v130", False)} == {"setup_s", "videos_per_s"}
    assert "flow_s.serve" in {m["name"] for m in r.metrics("serve.htah.v130", True)}
