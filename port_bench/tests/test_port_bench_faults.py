"""The check fails the control and every planted fault, and passes the
program, on runs driven through the harness at a tiny size on the CPU (the
look for a card is skipped: ``execute`` is given the CPU)."""

import time

import pytest

from port_bench.harness import faults
from port_bench.harness.core import execute


def run(registry, workload, mode="program", fault=None, trace=False, seed=2**31 + 12345):
    return execute(registry, workload, seed, 0.5, trace, "cpu", time.perf_counter(),
                   mode=mode, fault=fault)


@pytest.mark.parametrize("workload", ["tiny.serve", "tiny.ensemble", "tiny.train"])
def test_program_is_correct(tiny_registry, workload):
    out = run(tiny_registry, workload)
    assert out["result"]["correct"], out["result"]["check"]


@pytest.mark.parametrize("workload", ["tiny.serve", "tiny.ensemble", "tiny.train"])
def test_control_fails(tiny_registry, workload):
    out = run(tiny_registry, workload, mode="control")
    limits = tiny_registry.cell(workload)["limits"]
    assert any(out["record"].numbers[k] > v for k, v in limits.items())
    assert not out["result"]["correct"]


@pytest.mark.parametrize("workload", ["tiny.serve", "tiny.ensemble"])
@pytest.mark.parametrize("name", sorted(faults.SERVE))
def test_serve_faults_fail(tiny_registry, workload, name, monkeypatch):
    from video_classification_tpu_torch.pipeline import device_pipeline

    monkeypatch.setattr(device_pipeline, "video_flow_uint8", device_pipeline.video_flow_uint8)
    out = run(tiny_registry, workload, fault=faults.SERVE[name])
    assert not out["result"]["correct"], out["result"]["check"]


@pytest.mark.parametrize("name", sorted(faults.TRAIN))
def test_train_faults_fail(tiny_registry, name):
    out = run(tiny_registry, "tiny.train", fault=faults.TRAIN[name])
    assert not out["result"]["correct"], out["result"]["check"]


def test_traced_run_reports_per_layer_metrics(tiny_registry):
    out = run(tiny_registry, "tiny.serve", trace=True)
    res = out["result"]
    assert {"flow_s.serve", "crops_s.serve", "network_s.serve", "mfu.serve"} <= set(res["metrics"])
    assert res["device"]["window_s"] > 0 and "breakdown" in res
    assert list(res)[-1] == "check"
