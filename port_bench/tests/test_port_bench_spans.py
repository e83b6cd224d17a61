"""The program's spans and counts read from a traced run (harness/spans.py)
and the metrics read from them, on hand-made traces and records, and on a
traced tiny run on the CPU."""

import json
import time
from collections import Counter

import pytest

from port_bench.harness import spans
from port_bench.harness.core import Record, execute
from port_bench.harness.registry import Registry
from port_bench.harness.trace import WINDOW, Timeline, reduce_trace

US = 1e-6
NEW = ("k1_ms.serve", "flow_glue_ms.serve", "k1_roofline.serve", "network_dev_ms.serve",
       "upload_ms.serve", "launches.serve", "flow_pairs.serve", "data_wait_ms.train")


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def hand_trace():
    """Two requests on thread 1 (the flow with K1 and its glue, the network,
    the upload), a consumer's wait on thread 2 overlapping the first request
    in time, a launch under no span, a device operation with no launch."""
    ev = [_x(WINDOW, "user_annotation", 0, 2000)]
    for r, t0 in enumerate((10, 1010)):
        c = 10 * r
        ev += [
            _x("serve::request", "user_annotation", t0, 600),
            _x("serve::stream", "user_annotation", t0 + 5, 590),
            _x("stage::upload", "user_annotation", t0 + 6, 10),
            _x("cudaMemcpyAsync", "cuda_runtime", t0 + 8, 1, corr=c + 1),
            _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", t0 + 20, 30, tid=7, corr=c + 1),
            _x("stage::flow", "user_annotation", t0 + 20, 300),
            _x("kernel::flow_level", "user_annotation", t0 + 30, 50),
            _x("cudaLaunchKernelExC", "cuda_runtime", t0 + 35, 2, corr=c + 2),
            _x("flow_level_sor_tile_kernel", "kernel", t0 + 60, 200, tid=7, corr=c + 2),
            _x("kernel::flow_level", "gpu_user_annotation", t0 + 60, 200, tid=7),
            _x("aten::mul", "cpu_op", t0 + 100, 20),
            _x("cudaLaunchKernel", "cuda_runtime", t0 + 105, 2, corr=c + 3),
            _x("elementwise_kernel", "kernel", t0 + 270, 15, tid=7, corr=c + 3),
            _x("stage::network", "user_annotation", t0 + 400, 150),
            _x("cudaLaunchKernel", "cuda_runtime", t0 + 410, 2, corr=c + 4),
            _x("sm90_xmma_fprop", "kernel", t0 + 420, 100, tid=7, corr=c + 4),
        ]
    ev += [
        _x("data::wait", "user_annotation", 100, 400, tid=2),
        _x("cudaMemsetAsync", "cuda_runtime", 150, 1, tid=2, corr=50),
        _x("Memset (Device)", "gpu_memset", 160, 3, tid=7, corr=50),
        _x("cudaLaunchKernel", "cuda_runtime", 1900, 2, corr=60),
        _x("reduce_kernel", "kernel", 1910, 7, tid=7, corr=60),
        _x("orphan_kernel", "kernel", 1950, 9, tid=7, corr=99),
    ]
    return ev


def test_spans_from_a_hand_made_trace():
    s = spans.reduce_spans(hand_trace())
    assert set(s) == {"serve::request", "serve::stream", "stage::upload", "stage::flow",
                      "kernel::flow_level", "stage::network", "data::wait"}
    assert s["serve::request"] == pytest.approx(
        {"n": 2, "host_s": 1200 * US, "device_s": 2 * 345 * US, "launches": 8,
         "kernel_s": 400 * US})
    assert s["stage::flow"] == pytest.approx(
        {"n": 2, "host_s": 600 * US, "device_s": 430 * US, "launches": 4, "kernel_s": 400 * US})
    assert s["kernel::flow_level"] == pytest.approx(
        {"n": 2, "host_s": 100 * US, "device_s": 400 * US, "launches": 2, "kernel_s": 400 * US})
    assert s["stage::upload"]["device_s"] == pytest.approx(60 * US)
    assert s["stage::network"]["device_s"] == pytest.approx(200 * US)
    # The other thread's wait: its own memset only, not the request's work.
    assert s["data::wait"] == pytest.approx(
        {"n": 1, "host_s": 400 * US, "device_s": 3 * US, "launches": 1, "kernel_s": 0.0})


def _record(tmp_path, monkeypatch, events, **fields):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    monkeypatch.setattr(spans, "TRACE", path)
    busy_s, ops, gaps = reduce_trace(events, (0, 2000))
    return Record(timeline=Timeline(2000 * US, busy_s, ops, gaps, {}), **fields)


def test_readers_from_a_hand_made_record(tmp_path, monkeypatch):
    from video_classification_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "COUNTS", Counter({"flow.pairs": 202}))
    peak = 67e12
    rec = _record(tmp_path, monkeypatch, hand_trace(), trace_steps=4,
                  stage_work=[(1.0, 0.01 * peak), (1.0, 0.03 * peak)], peaks={"f32_op_per_s": peak})
    r = Registry()
    got = {m: r.reader(m).read(rec) for m in NEW}
    assert got == pytest.approx({
        "k1_ms.serve": 0.2, "flow_glue_ms.serve": 0.015, "k1_roofline.serve": 100 * 0.02 / 200e-6,
        "network_dev_ms.serve": 0.1, "upload_ms.serve": 0.03, "launches.serve": 4.0,
        "flow_pairs.serve": 101.0, "data_wait_ms.train": 0.1})
    assert all(r.reader(m).read(Record()) is None for m in NEW)


def test_readers_refuse_another_runs_trace(tmp_path, monkeypatch):
    """A trace file that is not the run's (its busy seconds differ), or a
    program without spans or counts, reads as nothing."""
    rec = _record(tmp_path, monkeypatch, hand_trace(), trace_steps=4)
    rec.timeline = rec.timeline._replace(busy_s=rec.timeline.busy_s + 1.0)
    assert spans.of(rec) is None
    assert Registry().reader("k1_ms.serve").read(rec) is None
    bare = [e for e in hand_trace() if not e["name"].startswith(spans.PREFIXES)]
    rec = _record(tmp_path, monkeypatch, bare, trace_steps=4)
    assert spans.of(rec) == {}
    assert all(Registry().reader(m).read(rec) is None for m in NEW)
    monkeypatch.setattr(spans, "PROGRAM", "no_such_module")
    assert spans.counts() is None


@pytest.mark.parametrize("workload", ["tiny.serve", "tiny.train"])
def test_traced_tiny_run_reads_the_programs_spans(tiny_registry, workload, monkeypatch,
                                                   tmp_path):
    from port_bench.harness import trace
    from video_classification_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "COUNTS", Counter())
    # The trace in a directory of this test's own, away from other runs'.
    traced = trace.traced
    monkeypatch.setattr(trace, "traced", lambda fn, _out, device: traced(fn, tmp_path, device))
    monkeypatch.setattr(spans, "TRACE", tmp_path / "trace.json")
    out = execute(tiny_registry, workload, 2**31 + 17, 0.5, True, "cpu", time.perf_counter())
    metrics = out["result"]["metrics"]
    if workload == "tiny.train":
        assert metrics["data_wait_ms.train"]["value"] >= 0
        return
    # The CPU queues no device operation: the device readings are 0, the
    # roofline has no time to divide by; the pairs are counted.
    s = spans.of(out["record"])
    assert s["serve::request"]["n"] == tiny_registry.traffic("tiny_serve")["trace_requests"]
    for name in ("k1_ms.serve", "flow_glue_ms.serve", "network_dev_ms.serve",
                 "upload_ms.serve", "launches.serve"):
        assert metrics[name]["value"] == 0
    assert "k1_roofline.serve" not in metrics
    pairs = metrics["flow_pairs.serve"]["value"]
    assert pairs > 0 and pairs * s["serve::request"]["n"] == profiling.COUNTS["flow.pairs"]
