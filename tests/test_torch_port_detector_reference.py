"""The benchmark's plain float32 DensePose detector
(``port_bench/reference/densepose.py``) against the port's, on the CPU, and
the port detector's spans and count (``utils/profiling``).

  * The reference's state-dict layout is the port's ``DensePoseRCNN``'s,
    names and shapes, at depth 50 and 101.
  * The whole detector at a small size (depth 50, 14-pixel chart pooler,
    128x192 padded frames, the online budget 256 / 64 / 8 with the chart of
    the best detection; seeded weights with the stem scaled by 0.01 and the
    box-delta layers by 0.02, as ``profile_preprocess.random_provider``):
    valid equal, boxes within 1e-3 px, charts equal on >= 99.9 % of pixels,
    U/V within 1e-3 where they agree (``test_torch_port_detector_serving``'s
    bars), scores within 1e-5.
  * On the port's own RPN head outputs the reference's anchors, top-k,
    decoding and NMS give the port's proposals and mask, and on the port's
    proposals and box head outputs its threshold, decoding and NMS give the
    port's detections: what the benchmark's ``proposal_off`` and
    ``detection_off`` compare on the chip. With the RPN's NMS at IoU 1 the
    proposals differ.
  * The benchmark configuration states the weight scalings its plug-in
    applies (``slowfast_densepose.SCALED``).
  * The reference's greedy NMS keeps the boxes the port's NMS keeps (the CPU
    twin of K3), and its ROIAlign, one level and over the FPN levels,
    pools what the port's does.
  * Under ``torch.profiler``, a request through ``Predictor`` with the
    DensePose detector opens ``stage::detect_backbone``, ``detect_rpn``,
    ``detect_box`` and ``detect_chart``, in this order, inside
    ``stage::detect``, and counts ``detect.frames``; with no profiler the
    count stays empty.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from port_bench.harness.registry import Registry
from port_bench.reference import densepose as ref_det
from port_bench.reference.crops import pad2x
from video_classification_tpu_torch.config import get_cfg
from video_classification_tpu_torch.detect import densepose as port_densepose
from video_classification_tpu_torch.detect.densepose import DensePoseRCNN, init_weights
from video_classification_tpu_torch.detect.nms import nms
from video_classification_tpu_torch.detect.ops import multilevel_roi_align, roi_align
from video_classification_tpu_torch.engine import Predictor
from video_classification_tpu_torch.ops.flow import FlowParams
from video_classification_tpu_torch.pipeline.online import DensePoseOnlineDetector
from video_classification_tpu_torch.utils import profiling
from video_classification_tpu_torch.utils.synthetic import coherent_motion_frames
from torch_port_support import configure_serving

BUDGET = dict(pre_nms_topk=256, post_nms_topk=64, max_detections=8, chart_pooler_size=14)
DETECT_SPANS = ("stage::detect_backbone", "stage::detect_rpn", "stage::detect_box",
                "stage::detect_chart")


def _scaled(model):
    """Seeded weights, the stem by 0.01 and the box deltas by 0.02."""
    init_weights(model, torch.Generator().manual_seed(3))
    with torch.no_grad():
        model.backbone.bottom_up.stem.conv1.weight.mul_(0.01)
        for layer in (model.proposal_generator["rpn_head"].anchor_deltas,
                      model.roi_heads["box_predictor"].bbox_pred):
            for p in layer.parameters():
                p.mul_(0.02)
    return model.eval()


@pytest.fixture(scope="module")
def detected():
    torch.manual_seed(0)
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    try:
        model = _scaled(DensePoseRCNN(depth=50, chart_topk=1, **BUDGET))
        frames = coherent_motion_frames(3, 64, 96, torch.Generator().manual_seed(5))
        x = ref_det.images(pad2x(frames))
        with torch.no_grad():
            got = model(x)
        ref = ref_det.DensePose({k: v.clone() for k, v in model.state_dict().items()}, 50,
                                **BUDGET)
        want = ref(x)
    finally:
        torch.set_num_threads(n)
    return got, want


@pytest.mark.parametrize("depth", [50, 101])
def test_layout_is_the_ports_state_dict(depth):
    with torch.device("meta"):
        model = DensePoseRCNN(depth=depth)
    port = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: shape for k, (shape, _) in ref_det.layout(depth).items()} == port


def test_detections_match_the_port(detected):
    got, want = detected
    assert got["valid"].shape == want["valid"].shape == (3, 8)
    assert torch.equal(got["valid"], want["valid"]) and bool(got["valid"][:, 0].all())
    torch.testing.assert_close(got["boxes"], want["boxes"], atol=1e-3, rtol=0)
    torch.testing.assert_close(got["scores"], want["scores"], atol=1e-5, rtol=0)
    box = got["boxes"][:, 0]
    assert bool(((box[:, 2] - box[:, 0]) > 8).all() & ((box[:, 3] - box[:, 1]) > 8).all())


def test_charts_match_the_port(detected):
    got, want = detected
    assert got["charts"].shape == want["charts"].shape == (3, 1, 56, 56)
    same = got["charts"].long() == want["charts"]
    assert float(same.float().mean()) >= 0.999
    assert len(torch.unique(got["charts"])) > 5
    for k in ("u", "v"):
        torch.testing.assert_close(got[k][same], want[k][same], atol=1e-3, rtol=0)


def _inside(model, x):
    """The port's RPN head outputs, proposals and mask, box head outputs and
    detections of ``x``."""
    seen = {}
    hooks = [model.proposal_generator["rpn_head"].register_forward_hook(
                 lambda m, i, o: seen.__setitem__("rpn", o)),
             model.roi_heads["box_predictor"].register_forward_hook(
                 lambda m, i, o: seen.__setitem__("box", o))]
    proposals = model._proposals

    def keep(feats, hw):
        seen["proposals"] = proposals(feats, hw)
        return seen["proposals"]

    model._proposals = keep
    try:
        with torch.no_grad():
            seen["out"] = model(x)
    finally:
        del model._proposals
        for h in hooks:
            h.remove()
    return seen


@pytest.fixture(scope="module")
def inside():
    model = _scaled(DensePoseRCNN(depth=50, chart_topk=1, **BUDGET))
    x = ref_det.images(pad2x(coherent_motion_frames(2, 64, 96, torch.Generator().manual_seed(7))))
    ref = ref_det.DensePose({k: v.clone() for k, v in model.state_dict().items()}, 50, **BUDGET)
    return model, x, ref, _inside(model, x)


def test_proposals_of_the_ports_rpn_outputs(inside):
    _, x, ref, seen = inside
    boxes, kept = ref.proposals_of(seen["rpn"], *x.shape[-2:])
    assert boxes.shape == (2, 64, 4) and int(kept.sum()) > 64
    assert torch.equal(kept, seen["proposals"][1])
    torch.testing.assert_close(boxes[kept], seen["proposals"][0][kept], atol=1e-4, rtol=0)


def test_detections_of_the_ports_box_outputs(inside):
    _, x, ref, seen = inside
    proposals, kept = seen["proposals"]
    cls, deltas = (t.reshape(2, 64, -1) for t in seen["box"])
    det = ref.detections(proposals, kept, cls, deltas, *x.shape[-2:])
    assert torch.equal(det["valid"], seen["out"]["valid"]) and bool(det["valid"].any())
    torch.testing.assert_close(det["boxes"], seen["out"]["boxes"], atol=1e-4, rtol=0)
    torch.testing.assert_close(det["scores"], seen["out"]["scores"], atol=1e-6, rtol=0)


def test_rpn_nms_at_iou_one_changes_the_proposals(inside, monkeypatch):
    model, x, ref, seen = inside
    nms_ = port_densepose.nms
    monkeypatch.setattr(port_densepose, "nms",
                        lambda b, s, m, t: nms_(b, s, m, 1.0 if t == 0.7 else t))
    faulty = _inside(model, x)
    want, kept = ref.proposals_of(faulty["rpn"], *x.shape[-2:])
    got = faulty["proposals"][0]
    assert not torch.allclose(got[kept], want[kept], atol=1e-2)


def test_config_states_the_plugins_scalings():
    plugin = Registry().model("slowfast_densepose")
    config = json.loads((Path(plugin.__file__).parent.parent / "configs"
                         / "slowfast-HTAH-densepose.json").read_text())
    assert config["assumed"]["detector weight scalings"] == plugin.SCALED
    layout = ref_det.layout(101)
    assert set(plugin.SCALED) <= set(layout)
    # The draw: a scaled tensor is its unscaled draw times the factor.
    state = plugin.detector_state_dict(50, 11, "cpu")
    cls = state["roi_heads.box_predictor.cls_score.weight"]
    assert abs(float(cls.std()) * (1024 ** 0.5) / plugin.SCALED[
        "roi_heads.box_predictor.cls_score.weight"] - 1) < 0.1


@pytest.mark.parametrize("n,max_out,threshold", [(300, 64, 0.7), (64, 8, 0.5), (40, 64, 0.3)])
def test_greedy_nms_keeps_what_the_port_keeps(n, max_out, threshold):
    g = torch.Generator().manual_seed(n)
    xy = torch.rand((4, n, 2), generator=g) * 100
    wh = torch.rand((4, n, 2), generator=g) * 40 + 1
    boxes = torch.cat([xy, xy + wh], dim=-1)
    scores = torch.rand((4, n), generator=g)
    scores[:, ::7] = scores[:, :1]                   # ties: the lower index first
    idx, mask = nms(boxes, scores, max_out, threshold)
    index, kept = ref_det.greedy_nms(boxes, scores, max_out, threshold)
    assert torch.equal(kept, mask)
    assert torch.equal(index, idx.long())


def _maps_and_boxes(seed):
    g = torch.Generator().manual_seed(seed)
    feats = [torch.randn((2, 8, 32 // s, 48 // s), generator=g) for s in (1, 2, 4, 8)]
    xy = torch.rand((2, 30, 2), generator=g) * torch.tensor([190.0, 125.0])
    wh = torch.rand((2, 30, 2), generator=g) ** 2 * 160
    boxes = torch.cat([xy, xy + wh], dim=-1)
    boxes[0, 0] = torch.tensor([0.0, 0.0, 192.0, 128.0])     # the whole frame
    boxes[0, 1] = torch.tensor([50.0, 60.0, 50.0, 60.0])     # empty
    return feats, boxes


def test_roi_align_pools_what_the_port_pools():
    feats, boxes = _maps_and_boxes(1)
    for size, scale in ((7, 0.25), (14, 0.125)):
        torch.testing.assert_close(ref_det.roi_align(feats[0], boxes, size, scale),
                                   roi_align(feats[0], boxes, size, scale),
                                   atol=1e-5, rtol=1e-5)


def test_level_roi_align_pools_what_the_port_pools():
    feats, boxes = _maps_and_boxes(2)
    feats = [f * 4 for f in feats]
    # every level gets boxes (sqrt(area) from 0 up to ~200 px on 4..32 strides)
    boxes = boxes * torch.tensor([1.0, 1.0, 4.0, 4.0])
    torch.testing.assert_close(ref_det.level_roi_align(feats, boxes, 7),
                               multilevel_roi_align(feats, boxes, 7), atol=1e-5, rtol=1e-5)


def _densepose_predictor(root):
    cfg = configure_serving(get_cfg(), root)
    cfg.CUDA.COMPUTE_DTYPE = "float32"
    cfg.DATA.ONLINE_DETECTOR = "densepose"
    det = DensePoseOnlineDetector(cfg, depth=50, chart_pooler_size=14, batch_size=2,
                                  allow_random_init=True, device="cpu")
    _scaled(det.model)
    return Predictor(cfg, detector=det, device="cpu",
                     flow_params=FlowParams(n_outer=1, n_sor=2, min_width=16))


def _frames():
    rgb = coherent_motion_frames(10, 64, 96, torch.Generator().manual_seed(3)).numpy()
    return rgb, rgb.mean(-1, keepdims=True).astype(np.uint8)


def test_detector_spans_nest_in_detect(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, "COUNTS", profiling.COUNTS.__class__())
    pred = _densepose_predictor(tmp_path)
    rgb, depth = _frames()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pred.predict_frames(rgb, depth)
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CPU and e.name.startswith("stage::detect")]
    detect = [(s, e) for n, s, e in spans if n == "stage::detect"]
    assert len(detect) == 1
    starts = []
    for name in DETECT_SPANS:
        inside = [(s, e) for n, s, e in spans if n == name]
        assert len(inside) == 1, name                 # one chunk of the 2 sampled frames
        assert detect[0][0] <= inside[0][0] and inside[0][1] <= detect[0][1], name
        starts.append(inside[0][0])
    assert starts == sorted(starts)
    assert profiling.COUNTS["detect.frames"] == 2


def test_no_profiler_no_count(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, "COUNTS", profiling.COUNTS.__class__())
    pred = _densepose_predictor(tmp_path)
    rgb, depth = _frames()
    out = pred.predict_frames(rgb, depth)
    assert out["clips"] == 1
    assert not profiling.COUNTS
