"""The check fails the control and every planted fault, and passes the
program, on runs driven through the harness at a tiny size on the CPU (the
look for a card is skipped: ``execute`` is given the CPU)."""

import time

import pytest

from port_bench.calibrate import plant
from port_bench.harness.core import execute
from port_bench.harness.registry import Registry

FAULTS = Registry().model("slowfast_streams").FAULTS


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
@pytest.mark.parametrize("name", sorted(FAULTS["serve"]))
def test_serve_faults_fail(tiny_registry, workload, name, monkeypatch):
    from video_classification_tpu_torch.pipeline import device_pipeline

    monkeypatch.setattr(device_pipeline, "video_flow_uint8", device_pipeline.video_flow_uint8)
    out = run(tiny_registry, workload, fault=FAULTS["serve"][name])
    assert not out["result"]["correct"], out["result"]["check"]


@pytest.mark.parametrize("name", sorted(FAULTS["train"]))
def test_train_faults_fail(tiny_registry, name):
    out = run(tiny_registry, "tiny.train", fault=FAULTS["train"][name])
    assert not out["result"]["correct"], out["result"]["check"]


def test_traced_run_reports_per_layer_metrics(tiny_registry):
    out = run(tiny_registry, "tiny.serve", trace=True)
    res = out["result"]
    assert {"flow_s.serve", "crops_s.serve", "network_s.serve", "mfu.serve"} <= set(res["metrics"])
    assert res["device"]["window_s"] > 0 and "breakdown" in res
    assert list(res)[-1] == "check"


@pytest.mark.parametrize("workload,name", [("tiny.serve", "flow_zero"),
                                           ("tiny.ensemble", "answer_altered"),
                                           ("tiny.train", "half_batch")])
def test_calibrate_plants_the_cells_fault(tiny_registry, workload, name):
    model = tiny_registry.model_of(tiny_registry.workload(workload)["config"])
    kind = tiny_registry.traffic(tiny_registry.workload(workload)["traffic"])["kind"]
    assert plant(tiny_registry, workload, name) == ("program", model.FAULTS[kind][name])
    assert plant(tiny_registry, workload, "control") == ("control", None)


@pytest.mark.parametrize("workload,name", [("tiny.serve", "half_batch"),
                                           ("tiny.train", "flow_zero"),
                                           ("tiny.ensemble", "flow_zeros")])
def test_calibrate_refuses_a_fault_the_cell_has_not(tiny_registry, workload, name):
    """A fault of the other kind, or a misspelt one, raises and names the
    faults there are, instead of running the sound program under its name."""
    with pytest.raises(ValueError, match=rf"no fault '{name}' .*faults are \["):
        plant(tiny_registry, workload, name)
