"""The port's spans and counts (utils/profiling: ``span``, ``stage``,
``count``) on the CPU.

  * Under ``torch.profiler``, one ``Predictor.predict_frames`` and one
    ``EnsemblePredictor.predict_frames`` each open one ``serve::request``;
    inside it, per stream and in this order in time, ``stage::upload``,
    ``stage::flow`` (holding the flow's ``kernel::`` spans),
    ``stage::crops`` and ``stage::network``, then, for the ensemble,
    ``stage::fuse``.
  * With no profiler, ``span`` and ``stage`` enter no ``record_function``,
    and a ``StageTimer`` still records the four stages.
  * ``COUNTS["flow.pairs"]`` goes up by the batch ``coarse2fine_flow``
    solves, and only while a profiler records.
  * Every kernel wrapper opens its ``kernel::<wrapper>`` span, and
    ``profile_serving`` groups device time by that span (a kernel under no
    such span by its name).
  * ``prefetch_to_device``'s consumer waits for each batch inside
    ``data::wait``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from video_classification_tpu_torch import profile_serving
from video_classification_tpu_torch.config import get_cfg
from video_classification_tpu_torch.data.pipeline import prefetch_to_device
from video_classification_tpu_torch.engine import EnsemblePredictor, Predictor
from video_classification_tpu_torch.ops.flow import FlowParams, coarse2fine_flow
from video_classification_tpu_torch.pipeline.online import SyntheticOnlineDetector
from video_classification_tpu_torch.utils import profiling
from video_classification_tpu_torch.utils.profiling import COUNTS, StageTimer
from video_classification_tpu_torch.utils.synthetic import coherent_motion_frames
from torch_port_support import configure_serving, one_torch_thread  # noqa: F401

FLOW = FlowParams(n_outer=1, n_sor=2, min_width=16)
STREAM_STAGES = ("stage::upload", "stage::flow", "stage::crops", "stage::network")


def _frames(t=10):
    rgb = coherent_motion_frames(t, 64, 96, torch.Generator().manual_seed(3)).numpy()
    return rgb, rgb.mean(-1, keepdims=True).astype(np.uint8)


def _predictor(root):
    cfg = configure_serving(get_cfg(), root)
    cfg.CUDA.COMPUTE_DTYPE = "float32"
    return Predictor(cfg, detector=SyntheticOnlineDetector(), device="cpu", flow_params=FLOW)


def _ensemble(root):
    return EnsemblePredictor(
        ["slowfast-RHand", "slowfast-LHand"],
        ["CHALEARN.ROOT", str(root), "CHALEARN.NUM_CLASS", "3", "CHALEARN.CLIP_LEN", "2",
         "CHALEARN.BATCH_SIZE", "2", "MODEL.DEPTH", "18", "CUDA.COMPUTE_DTYPE", "float32"],
        detector=SyntheticOnlineDetector(), flow_params=FLOW, device="cpu")


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CPU and "::" in e.name
            and e.name.split("::")[0] in ("serve", "stage", "kernel", "data")]


def _inside(spans, outer, name):
    return sorted((s, e) for n, s, e in spans if n == name and outer[0] <= s and e <= outer[1])


@pytest.mark.parametrize("ensemble", [False, True], ids=["predictor", "ensemble"])
def test_request_spans_nest_in_time(tmp_path, ensemble):
    pred = _ensemble(tmp_path) if ensemble else _predictor(tmp_path)
    rgb, depth = _frames()
    pred.predict_frames(rgb, depth)     # the fusion's first load outside the profile
    spans = _profiled(lambda: pred.predict_frames(rgb, depth))
    requests = [(s, e) for n, s, e in spans if n == "serve::request"]
    assert len(requests) == 1 and pred.requests == 2
    streams = _inside(spans, requests[0], "serve::stream")
    assert len(streams) == (2 if ensemble else 1)
    for stream in streams:
        starts = []
        for name in STREAM_STAGES:
            inside = _inside(spans, stream, name)
            assert inside, name
            starts.append(inside[0][0])
        assert starts == sorted(starts)
        for flow in _inside(spans, stream, "stage::flow"):
            assert _inside(spans, flow, "kernel::flow_level")
        stages = _inside(spans, stream, "stage::flow") + _inside(spans, stream, "stage::crops")
        for n, s, e in spans:
            if n.startswith("kernel::") and stream[0] <= s and e <= stream[1]:
                assert any(a <= s and e <= b for a, b in stages), n
    fuse = _inside(spans, requests[0], "stage::fuse")
    if ensemble:
        assert len(fuse) == 1 and fuse[0][0] >= streams[-1][1]
    else:
        assert not fuse


def test_no_profiler_no_record_function(tmp_path, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("serve::request") is profiling.span("stage::flow")
    pred = _predictor(tmp_path)
    pred.timer = StageTimer("cpu")
    rgb, depth = _frames()
    pred.predict_frames(rgb, depth)
    assert set(pred.timer.seconds) == {"detect", "flow", "crops", "network"}
    assert all(v > 0 for v in pred.timer.seconds.values())
    with profiling.stage(None, "flow"), profiling.stage(StageTimer("cpu"), "crops"):
        pass


def test_flow_pairs_counted_while_profiling(monkeypatch):
    monkeypatch.setattr(profiling, "COUNTS", COUNTS.copy())
    from video_classification_tpu_torch.ops import flow

    gen = torch.Generator().manual_seed(5)
    im1, im2 = torch.rand((3, 20, 24, 3), generator=gen), torch.rand((3, 20, 24, 3), generator=gen)
    params = FlowParams(n_outer=1, n_sor=2, min_width=16)
    before = profiling.COUNTS["flow.pairs"]
    coarse2fine_flow(im1, im2, params)
    assert profiling.COUNTS["flow.pairs"] == before
    _profiled(lambda: coarse2fine_flow(im1, im2, params))
    assert profiling.COUNTS["flow.pairs"] == before + 3
    frames = coherent_motion_frames(4, 20, 24, gen)
    _profiled(lambda: flow.video_flow_uint8(frames, params))
    assert profiling.COUNTS["flow.pairs"] == before + 3 + 4


def _wrapper_calls():
    from video_classification_tpu_torch.detect.nms import nms
    from video_classification_tpu_torch.ops.component_extents import component_extents
    from video_classification_tpu_torch.ops.flow_level import flow_level
    from video_classification_tpu_torch.ops.irls import irls_coefficients
    from video_classification_tpu_torch.ops.label_components import label_components
    from video_classification_tpu_torch.ops.sor_solve import sor_solve
    from video_classification_tpu_torch.ops.warp import warp_bilinear

    gen = torch.Generator().manual_seed(7)
    im = torch.rand((1, 8, 8, 3), generator=gen)
    f = torch.rand((1, 8, 8), generator=gen)
    mask = f > 0.5
    boxes = torch.tensor([[[0.0, 0.0, 4.0, 4.0], [1.0, 1.0, 5.0, 5.0], [6.0, 6.0, 8.0, 8.0]]])
    return {
        flow_level: lambda: flow_level(im, im.flip(2), f, f, 1, 2, 0.012, 1.8, 1e-6, 8, 0.005),
        component_extents: lambda: component_extents(mask),
        nms: lambda: nms(boxes, torch.tensor([[0.9, 0.8, 0.7]]), 2),
        sor_solve: lambda: sor_solve(f + 1, *[f] * 10, 2, 0.012, 1.8),
        warp_bilinear: lambda: warp_bilinear(im, f, f),
        label_components: lambda: label_components(mask),
        irls_coefficients: lambda: irls_coefficients(im, im, im, f, f, f * 0, f * 0, 1e-6),
    }


@pytest.mark.parametrize("name", [w.__name__ for w in profile_serving.WRAPPERS])
def test_every_wrapper_opens_its_kernel_span(name):
    calls = {w.__name__: c for w, c in _wrapper_calls().items()}
    assert set(calls) == {w.__name__ for w in profile_serving.WRAPPERS}
    spans = {n for n, _s, _e in _profiled(calls[name]) if n.startswith("kernel::")}
    assert spans == {f"kernel::{name}"}
    assert profile_serving.group_of("any_kernel(int)", ["aten::copy_", *spans,
                                                        "stage::flow"]) == name
    assert name in profile_serving.GROUPS


def test_profile_serving_groups_by_span():
    """Device time goes to the wrapper's span above the call that launched
    it (matched by correlation id), the libraries' kernels outside one by
    name, the rest to 'other'; a range's own annotation on the device is
    not an operation."""
    def host(name, parent, id=0):
        return SimpleNamespace(name=name, cpu_parent=parent, device_type=DeviceType.CPU, id=id)

    def device(name, id, us):
        return SimpleNamespace(name=name, device_type=DeviceType.CUDA, id=id,
                               time_range=SimpleNamespace(start=1000.0, end=1000.0 + us))

    request = host("serve::request", None, 1)
    flow = host("stage::flow", request, 2)
    span = host("kernel::flow_level", flow, 3)
    mul = host("aten::mul", flow, 4)
    conv = host("aten::cudnn_convolution", request, 5)
    extents = host("kernel::component_extents", request, 6)
    copy = host("aten::copy_", extents, 7)
    events = [request, flow, span, mul, conv, extents, copy,
              host("cudaLaunchKernelExC", span, 41), device("coeff_kernel(Level)", 41, 300.0),
              device("kernel::flow_level", 3, 900.0),
              host("cudaLaunchKernel", mul, 42),
              device("void at::native::vectorized_elementwise_kernel<4>()", 42, 50.0),
              host("cudaLaunchKernel", conv, 43),
              device("sm90_xmma_fprop_implicit_gemm", 43, 200.0),
              host("cudaMemcpyAsync", copy, 44), device("Memcpy DtoD (Device -> Device)", 44, 10.0),
              device("void at::native::elementwise_kernel<128>()", 4, 7.0)]
    t = profile_serving.device_time(SimpleNamespace(events=lambda: events))
    assert t["groups"]["flow_level"] == {"ms": 0.3, "launches": 1}
    assert t["groups"]["other"] == {"ms": pytest.approx(0.057), "launches": 2}
    assert t["groups"]["conv_and_matmul"] == {"ms": 0.2, "launches": 1}
    assert t["groups"]["component_extents"] == {"ms": 0.01, "launches": 1}
    assert "kernel::flow_level" not in t["kernels"]
    assert profile_serving.group_of("void at::native::vectorized_elementwise_kernel<4>()",
                                    []) == "other"


def test_prefetch_waits_inside_data_wait():
    def batches():
        for i in range(3):
            yield {"x": np.full((2, 2), i, np.float32)}

    spans = _profiled(lambda: [b for b in prefetch_to_device(batches(), "cpu", depth=1)])
    assert [n for n, _s, _e in spans].count("data::wait") == 4     # three batches, the end
    spans = _profiled(lambda: [b for b in prefetch_to_device(batches(), "cpu", depth=0)])
    assert not spans
