"""slowfast_densepose at a tiny size on the CPU: the cell's check numbers at
two seeds inside float32 limits, the control and each detector fault past
one, a traced run reading the detector's metrics, and the detector's FLOP
count on meta tensors against a count of the reference run on real ones."""

import json
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.counts import densepose_flops
from port_bench.harness.core import execute
from port_bench.harness.registry import Registry
from port_bench.reference import densepose as ref_det

from .conftest import TINY_CONFIG, write_tiny

DETECTOR = {"depth": 50, "resnet_stages": [3, 4, 6, 3], "fpn_channels": 256, "box_hidden": 1024,
            "head_hidden": 512, "head_convs": 8, "aspp_rates": [6, 12, 56], "charts": 25,
            "chart_pooler_size": 14, "heatmap_size": 56, "pre_nms_topk": 256,
            "post_nms_topk": 64, "max_detections": 8, "chart_topk": 1, "batch_size": 4,
            "compute_dtype": "float32"}
TINY_DENSEPOSE = dict(TINY_CONFIG, name="tinydp", model="slowfast_densepose",
                      opts=dict(TINY_CONFIG["opts"], **{"DATA.ONLINE_DETECTOR": "densepose"}),
                      detector=DETECTOR)
# Float32 end to end on the CPU: the program and the reference agree to its
# rounding, and these limits hold them to that.
LIMITS = {"logp_gap": 1e-3, "flow_off": 0.01, "clips_off": 0, "det_score_gap": 1e-4,
          "box_gap": 1e-3, "chart_off": 1e-3, "uv_gap": 1e-3, "proposal_off": 0,
          "detection_off": 0}
DETECTOR_FAULTS = ("chart_second", "box_deltas_dropped", "rpn_nms_off", "box_nms_off")


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    pkg = tmp_path_factory.mktemp("densepose") / "bench"
    bench_file = write_tiny(pkg)
    (pkg / "configs" / "tinydp.json").write_text(json.dumps(TINY_DENSEPOSE))
    (pkg / "cells" / "tiny.densepose.json").write_text(
        json.dumps({"check": {"requests": 2}, "limits": LIMITS}))
    bench = json.loads(bench_file.read_text())
    bench["workloads"].append({"name": "tiny.densepose", "config": "tinydp",
                               "traffic": "tiny_serve", "chips": 1, "why": "t"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny.serve" in m.get("workloads", []):
            m["workloads"].append("tiny.densepose")
    bench_file.write_text(json.dumps(bench))
    return Registry(pkg, bench_file)


def run(registry, mode="program", fault=None, trace=False, seed=2**31 + 12345):
    return execute(registry, "tiny.densepose", seed, 0.5, trace, "cpu", time.perf_counter(),
                   mode=mode, fault=fault)


@pytest.mark.parametrize("seed", [2**31 + 12345, 6 * 2**30 + 7])
def test_program_is_correct(registry, seed):
    out = run(registry, seed=seed)
    numbers = out["record"].numbers
    assert set(LIMITS) <= set(numbers)
    assert out["result"]["correct"], out["result"]["check"]
    # Every sampled frame has a valid best detection, and the shares count
    # the proposals and detections they compare.
    seen = out["record"].notes["detections"]
    assert seen["valid"] == seen["frames"] > 0, seen
    assert seen["proposals"] > 0 and seen["detections"] > 0, seen


def test_control_fails(registry):
    out = run(registry, mode="control")
    numbers = out["record"].numbers
    assert any(numbers[k] > v for k, v in LIMITS.items()), numbers
    assert not out["result"]["correct"]


# The number each detector fault moves past its limit.
FAULT_NUMBER = {"chart_second": "chart_off", "box_deltas_dropped": "box_gap",
                "rpn_nms_off": "proposal_off", "box_nms_off": "detection_off"}


@pytest.mark.parametrize("name", DETECTOR_FAULTS)
def test_detector_faults_fail(registry, name):
    faults = registry.model("slowfast_densepose").FAULTS["serve"]
    out = run(registry, fault=faults[name])
    assert not out["result"]["correct"], out["result"]["check"]
    assert out["record"].numbers[FAULT_NUMBER[name]] > LIMITS[FAULT_NUMBER[name]]


def test_unmatched_counts_each_side_once():
    """A box that one side keeps and the other replaces counts once a side;
    rows outside either mask and shifts within the tolerance do not count."""
    unmatched = Registry().model("slowfast_densepose").unmatched
    a = torch.tensor([[[0., 0, 10, 10], [20, 20, 30, 30], [5, 5, 6, 6]]])
    b = torch.tensor([[[20, 20, 30, 30.005], [0, 0, 10, 10], [40, 40, 50, 50]]])
    tol = torch.full((4,), 0.01)
    ok = torch.tensor([[True, True, True]])
    assert unmatched(a, ok, b, ok, tol) == (2, 6)
    assert unmatched(a, ok, b, torch.tensor([[True, True, False]]), tol) == (1, 5)
    assert unmatched(a, ok, a, ok, tol) == (0, 6)


def test_faults_hold_the_streams_and_the_detectors():
    faults = Registry().model("slowfast_densepose").FAULTS["serve"]
    streams = Registry().model("slowfast_streams").FAULTS["serve"]
    assert set(faults) == set(streams) | set(DETECTOR_FAULTS)


def test_traced_run_reads_the_detector(registry):
    """The program's detector spans and count read through the new readers;
    every request detects the sampled frames of its window once."""
    res = run(registry, trace=True)["result"]
    metrics = {k: v["value"] for k, v in res["metrics"].items()}
    for name in ("detect_s.serve", "detect_dev_ms.serve", "detect_backbone_ms.serve",
                 "detect_launches.serve", "detect_max_s.serve"):
        assert name in metrics, name
    assert metrics["detect_max_s.serve"] >= metrics["detect_s.serve"]
    assert "detect_roofline.serve" not in metrics       # no device time on the CPU
    # The tiny mix serves 12- and 45-frame videos: 3 and 8 distinct sampled
    # frames (one window; two of 4), and the trace holds two requests.
    assert metrics["detect_frames.serve"] in (3.0, 5.5, 8.0)


def test_flop_count_on_meta_equals_a_real_run():
    """``frame_flops`` (meta tensors) against FlopCounterMode over the whole
    reference detector run on one real frame, whose box head sees the
    budget's proposals and whose chart branch one box."""
    depth, h, w, proposals, pooler = 50, 128, 192, 64, 14
    state = Registry().model("slowfast_densepose").detector_state_dict(depth, 5, "cpu")
    det = ref_det.DensePose(state, depth, pre_nms_topk=256, post_nms_topk=proposals,
                            max_detections=8, chart_pooler_size=pooler)
    with FlopCounterMode(display=False) as counter:
        out = det(torch.randn(1, 3, h, w) * 50)
    assert out["proposals"].shape == (1, proposals, 4)
    assert densepose_flops.frame_flops(depth, h, w, proposals, 1, pooler) == \
        counter.get_total_flops()
