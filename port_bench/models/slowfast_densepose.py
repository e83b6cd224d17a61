"""slowfast_densepose: slowfast-HTAH served behind DensePose R-CNN
R101-FPN-DL, the detector the reference pipeline takes its body-part crops
from, built on ``slowfast_streams``' serving plug-in.

Serving (``serve``): the program is ``engine/predictor.Predictor
.predict_frames`` with ``detector=pipeline/online.DensePoseOnlineDetector``
(``DATA.ONLINE_DETECTOR densepose``) at the configuration's ``detector``
budget; its weights go in as a ``state_dict`` made on the device from the
seed (``detector_state_dict``), the stream's as ``slowfast_streams`` makes
them. A request's work adds the detector's bf16 FLOPs
(``counts/densepose_flops.py``) on each frame it detects to the stream's.

The check: ``DetectorCapture`` keeps what the detector computed for the
sampled videos' last requests, on the device, in slots made in set-up: the
RPN head's objectness and deltas, the proposals and their mask, the box
head's class logits and box deltas, and the detections (boxes, scores,
valid, the chart and U/V of the best). The plain float32 detector
(``reference.densepose``) is then judged on the program's own inputs, since
bf16 and float32 pick other boxes at random weights:

  * ``proposal_off``: the share of the proposals (the program's kept ones
    and the reference's) with no match on the other side within
    ``PROPOSAL_PX`` in every coordinate, the reference's anchors, top-k,
    decoding and NMS run on the program's RPN head outputs;
  * ``detection_off``: the same share of the valid detections (box and
    score), the reference's decoding, threshold and NMS run on the
    program's proposals, mask, logits and deltas;
  * ``det_score_gap``: the widest gap of the person score (softmax column
    0) of the box head, the reference's on the program's proposals against
    the program's;
  * ``box_gap``: the widest gap in pixels between the program's best box and
    the reference's decoding of the proposal it came from (inf where the
    two disagree on its validity, or no proposal scores the program's best
    score);
  * ``chart_off``: the share of the best detection's foreground chart pixels
    (either side's part > 0) whose part differs, the reference's DeepLab
    head run on the program's box; ``uv_gap``: the widest U or V gap where
    the parts agree;
  * ``logp_gap``, ``flow_off``, ``clips_off``: as ``slowfast_streams``, the
    reference's crops made from the program's captured detections
    (``reference.given_crops``) as ``DensePoseOnlineDetector`` hands them to
    the crops: per frame the best-scoring box and its validity, the chart
    and U/V of detection 0.

The control puts the reference one precision down in the program's place:
the detector's and the stream's convolution and linear operands in fp8
E4M3 (``reference.precision.FP8``), the flow in bfloat16.

``FAULTS["serve"]`` holds ``slowfast_streams``' serving faults and four of
the detector's own.
"""

from __future__ import annotations

import math
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Tuple

import numpy as np
import torch

from port_bench.counts import densepose_flops
from port_bench.harness import check
from port_bench.harness.core import Context, Record
from port_bench.harness.registry import Registry
from port_bench.reference import densepose as ref_det
from port_bench.reference import given_crops
from port_bench.reference import serve as ref
from port_bench.reference.crops import pad2x
from port_bench.reference.flow import BF16, F32
from port_bench.reference.precision import FP8, strict_float32
from port_bench.reference.slowfast import FLOAT32, SlowFast


def _streams_plugin():
    """``slowfast_streams`` beside this file, loaded as ``Registry.model``
    loads it (one module a file and process, so it is the module that
    ``ctx.registry.model("slowfast_streams")`` returns)."""
    here = SimpleNamespace(package=Path(__file__).resolve().parent.parent)
    return Registry._module(here, "models", "slowfast_streams")


streams = _streams_plugin()

DETECTOR_SEED = -2                  # the detector's ``stream_seed`` index
WEIGHTS = ("conv", "deconv", "linear")
# The stem and the two box regressors as profile_preprocess.random_provider
# scales them (else every box collapses onto the frame's border); the person
# logits so that the score sits near 0.5 on every seed (unscaled, the hidden
# layer's common mode puts every score of some seeds under the 0.05
# threshold, and such a seed detects nothing).
SCALED = {"backbone.bottom_up.stem.conv1.weight": 0.01,
          "proposal_generator.rpn_head.anchor_deltas.weight": 0.02,
          "proposal_generator.rpn_head.anchor_deltas.bias": 0.02,
          "roi_heads.box_predictor.bbox_pred.weight": 0.02,
          "roi_heads.box_predictor.bbox_pred.bias": 0.02,
          "roi_heads.box_predictor.cls_score.weight": 0.1}
PROPOSAL_PX = 0.01      # a box matches within this many pixels a coordinate
SCORE_TOL = 1e-4        # and a detection's score within this
# The configuration's published widths, held against the reference's.
WIDTHS = {"fpn_channels": ref_det.FPN, "box_hidden": ref_det.BOX_HIDDEN,
          "head_hidden": ref_det.HEAD_HIDDEN, "head_convs": ref_det.HEAD_CONVS,
          "aspp_rates": list(ref_det.ASPP_RATES), "charts": ref_det.CHARTS}


# ---- weights ----------------------------------------------------------------

def detector_state_dict(depth: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """The detector's state dict (``reference.densepose.layout``), float32
    on ``device``, drawn as the program's ``detect/densepose.init_weights``
    draws it: weights N(0, 1 / fan_in) from one ``torch.Generator`` seeded
    with ``seed``, biases 0, norms the identity; then ``SCALED``."""
    layout = ref_det.layout(depth)
    g = torch.Generator(device).manual_seed(int(seed))
    pool = torch.randn(sum(math.prod(s) for s, kind in layout.values() if kind in WEIGHTS),
                       generator=g, device=device)
    at, out = 0, {}
    for name, (shape, kind) in layout.items():
        if kind not in WEIGHTS:
            out[name] = (torch.ones if kind == "scale" else torch.zeros)(shape, device=device)
            continue
        n = math.prod(shape)
        fan_in = shape[0] * shape[2] * shape[3] if kind == "deconv" else math.prod(shape[1:])
        out[name] = pool[at:at + n].view(shape) * (math.sqrt(1.0 / fan_in) * SCALED.get(name, 1.0))
        at += n
    return out


# ---- what the detector sees ---------------------------------------------------

def detected_frames(length: int, clip_len: int, interval: int) -> np.ndarray:
    """The raw frames the program's detector sees for a request of
    ``length`` raw frames, in its order: per window, the sampled frames no
    earlier window had, sorted (``OnlineVideoDataset._detections_for``)."""
    seen, order = set(), []
    for w in ref.window_indices(length, clip_len, interval):
        new = sorted({int(r) for r in given_crops.sampled_frames(w, interval)} - seen)
        order += new
        seen.update(new)
    return np.asarray(order, dtype=np.int64)


def handed_on(out: Dict[str, torch.Tensor]):
    """The detections ``DensePoseOnlineDetector`` hands to the crops, from
    the detector's outputs: per frame the best-scoring box and its validity,
    the chart and U/V of detection 0."""
    rows = torch.arange(out["boxes"].shape[0], device=out["boxes"].device)
    best = torch.argmax(out["scores"], dim=1)
    return (out["boxes"][rows, best], out["valid"][rows, best], out["charts"][:, 0],
            torch.stack([out["u"][:, 0], out["v"][:, 0]], dim=1))


class DetectorCapture:
    """The detector's side of the timed path for the sampled videos,
    copied on the device into slots made in set-up: the RPN head's outputs
    per level (a forward hook on ``proposal_generator.rpn_head``, in the
    compute dtype), the proposals' mask (the first ``detect/densepose.nms``
    call after that hook: the RPN's), the proposals (where
    ``multilevel_roi_align`` receives them), the box head's class logits and
    box deltas (a forward hook on ``roi_heads.box_predictor``) and the
    detections (a forward hook on the detector): no method of
    ``DensePoseRCNN`` but ``forward``, so a detector whose forward is one
    function is captured too. A sampled video's rows
    hold its last request's frames in the detector's order
    (``detected_frames``); ``levels`` are the RPN's (H, W) on a padded
    frame. ``bytes`` is the slots' device memory."""

    def __init__(self, frames: Dict, levels, proposals: int, detections: int, heatmap: int,
                 dtype, device):
        self.rows, n = {}, 0
        for key, raw in frames.items():
            self.rows[key] = (n, len(raw))
            n += len(raw)
        self.p, self.levels = proposals, len(levels)
        cuda = torch.device(device).type == "cuda"
        before = torch.cuda.memory_allocated(device) if cuda else 0

        def slot(*shape, dtype=torch.float32):
            return torch.zeros((n, *shape), dtype=dtype, device=device)

        self.out = {"proposals": slot(proposals, 4), "kept": slot(proposals, dtype=torch.bool),
                    "cls": slot(proposals, 2), "deltas": slot(proposals, 4),
                    "boxes": slot(detections, 4), "scores": slot(detections),
                    "valid": slot(detections, dtype=torch.bool),
                    "charts": slot(1, heatmap, heatmap, dtype=torch.int32),
                    "u": slot(1, heatmap, heatmap), "v": slot(1, heatmap, heatmap)}
        for i, (h, w) in enumerate(levels):
            self.out[f"obj{i}"] = slot(len(ref_det.RATIOS), h, w, dtype=dtype)
            self.out[f"anchor_deltas{i}"] = slot(4 * len(ref_det.RATIOS), h, w, dtype=dtype)
        self.bytes = (torch.cuda.memory_allocated(device) - before) if cuda else 0
        self.key, self.at, self.rpn_nms = None, 0, False
        self.hooks: List = []
        self.module = self.saved = None

    def start(self, key) -> None:
        """The next request is ``key``'s (None: not sampled)."""
        self.key, self.at = key, 0

    def _rows(self, b: int):
        if self.key not in self.rows:
            return None
        start, n = self.rows[self.key]
        if self.at + b > n:
            raise RuntimeError(f"the detector saw more than the {n} frames of {self.key}")
        return slice(start + self.at, start + self.at + b)

    def install(self, model) -> None:
        from video_classification_tpu_torch.detect import densepose as program

        self.module = program
        self.saved = {"nms": program.nms, "multilevel_roi_align": program.multilevel_roi_align}
        nms, roi_align = self.saved["nms"], self.saved["multilevel_roi_align"]

        def rpn_outputs(_module, _inputs, output):
            self.rpn_nms = True
            rows = self._rows(output[0][0].shape[0])
            if rows is not None:
                for i, (obj, deltas) in enumerate(output):
                    self.out[f"obj{i}"][rows].copy_(obj)
                    self.out[f"anchor_deltas{i}"][rows].copy_(deltas)

        def rpn_kept(boxes, scores, max_out, *args, **kwargs):
            index, kept = nms(boxes, scores, max_out, *args, **kwargs)
            if self.rpn_nms:
                self.rpn_nms = False
                rows = self._rows(boxes.shape[0])
                if rows is not None:
                    self.out["kept"][rows].copy_(kept)
            return index, kept

        def proposals(feats, boxes, *args, **kwargs):
            rows = self._rows(boxes.shape[0])
            if rows is not None:
                self.out["proposals"][rows].copy_(boxes)
            return roi_align(feats, boxes, *args, **kwargs)

        def box_outputs(_module, _inputs, output):
            cls, deltas = output
            rows = self._rows(cls.shape[0] // self.p)
            if rows is not None:
                self.out["cls"][rows].copy_(cls.reshape(-1, self.p, 2))
                self.out["deltas"][rows].copy_(deltas.reshape(-1, self.p, 4))

        def detections(_module, _inputs, output):
            b = output["boxes"].shape[0]
            rows = self._rows(b)
            if rows is not None:
                for k in ("boxes", "scores", "valid"):
                    self.out[k][rows].copy_(output[k])
                for k in ("charts", "u", "v"):
                    self.out[k][rows].copy_(output[k][:, :1])
            self.at += b

        program.nms, program.multilevel_roi_align = rpn_kept, proposals
        self.hooks = [
            model.proposal_generator["rpn_head"].register_forward_hook(rpn_outputs),
            model.roi_heads["box_predictor"].register_forward_hook(box_outputs),
            model.register_forward_hook(detections)]

    def of(self, key) -> Dict:
        start, n = self.rows[key]
        got = {k: v[start:start + n] for k, v in self.out.items()}
        got["rpn"] = [(got.pop(f"obj{i}"), got.pop(f"anchor_deltas{i}"))
                      for i in range(self.levels)]
        return got

    def remove(self) -> None:
        if self.module is not None:
            for name, fn in self.saved.items():
                setattr(self.module, name, fn)
            self.module = None
        for h in self.hooks:
            h.remove()
        self.hooks = []


# ---- serving ----------------------------------------------------------------

class Serving(streams.Serving):
    """The serving kind's plug-in (``kinds/serve.py`` lists what it asks):
    ``slowfast_streams.Serving`` with the DensePose detector in the
    predictor, its FLOPs in the work, its capture and its check."""

    def __init__(self, ctx: Context):
        super().__init__(ctx)
        spec = ctx.config["detector"]
        widths = dict(WIDTHS, resnet_stages=list(ref_det.STAGES[int(spec["depth"])]),
                      heatmap_size=4 * int(spec["chart_pooler_size"]))
        for key, want in widths.items():
            if spec[key] != want:
                raise ValueError(f"detector {key} reads {spec[key]!r}; the reference has {want!r}")
        if len(self.names) != 1:
            raise ValueError("slowfast_densepose serves one stream behind the detector")
        self.spec = spec
        self.det_cap = None
        self.detect_flop = None     # bf16 FLOPs of a request's detections, over a cycle

    def _detector_args(self) -> Dict:
        return {k: int(self.spec[k]) for k in ("depth", "pre_nms_topk", "post_nms_topk",
                                               "max_detections", "chart_pooler_size")}

    def detected(self, length: int) -> np.ndarray:
        return detected_frames(length, self.clip_len, self.interval)

    def prepare(self, traffic, sample) -> None:
        super().prepare(traffic, sample)
        a = self._detector_args()
        self.frame_flop = densepose_flops.frame_flops(
            a["depth"], 2 * self.mix["height"], 2 * self.mix["width"], a["post_nms_topk"],
            int(self.spec["chart_topk"]), a["chart_pooler_size"])
        self.detect_flop = float(np.mean([len(self.detected(k[0])) for k in traffic.keys])
                                 * self.frame_flop)
        self.ctx.mark("detector flop count")
        h, w = (-(-2 * self.mix[k] // 64) * 64 for k in ("height", "width"))
        self.det_cap = DetectorCapture({k: self.detected(k[0]) for k in sample},
                                       [(h // s, w // s) for s in ref_det.STRIDES],
                                       a["post_nms_topk"], a["max_detections"],
                                       4 * a["chart_pooler_size"],
                                       getattr(torch, self.spec["compute_dtype"]), self.ctx.device)
        self.capture_bytes += self.det_cap.bytes

    def work(self, length: int):
        flop, ops = super().work(length)
        return flop + len(self.detected(length)) * self.frame_flop, ops

    def build(self) -> None:
        from video_classification_tpu_torch.engine.predictor import Predictor
        from video_classification_tpu_torch.pipeline.online import DensePoseOnlineDetector

        ctx, dev, a = self.ctx, self.ctx.device, self._detector_args()
        detector = DensePoseOnlineDetector(
            self.cfgs[0], state_dict=detector_state_dict(
                a["depth"], streams.stream_seed(ctx.seed, DETECTOR_SEED), dev),
            batch_size=int(self.spec["batch_size"]), compute_dtype=self.spec["compute_dtype"],
            device=dev, **a)
        self.pred = Predictor(self.cfgs[0], detector=detector, device=dev,
                              state_dict=streams.stream_state_dict(
                                  self.classes, self.depth, streams.stream_seed(ctx.seed, 0), dev))
        self.streams = {self.names[0]: self.pred}
        ctx.mark("predictor")
        if ctx.fault is not None:
            ctx.fault(self.pred, self.streams)
        self.cap.install(self.streams)
        self.det_cap.install(detector.model)
        self.predict = self.pred.predict_frames

    def capturing(self, key) -> None:
        super().capturing(key)
        self.det_cap.start(key)

    def free(self) -> None:
        if self.det_cap is not None:
            self.det_cap.remove()
        super().free()

    def check(self, rec: Record, traffic, sample) -> None:
        """The sampled requests judged once the program is freed: the
        detector's numbers on the program's RPN and box head outputs,
        proposals and boxes, then the
        stream on the reference's crops of the program's detections. The
        control puts the reference in the program's place one precision
        down."""
        ctx, dev, fp = self.ctx, self.ctx.device, self.fp
        a = self._detector_args()
        folder = self.cfgs[0].MODEL.R3D_INPUT
        budget = {k: a[k] for k in ("pre_nms_topk", "post_nms_topk", "max_detections",
                                    "chart_pooler_size")}
        state = detector_state_dict(a["depth"], streams.stream_seed(ctx.seed, DETECTOR_SEED), dev)
        detector = ref_det.DensePose(state, a["depth"], **budget)
        control = ref_det.DensePose(state, a["depth"], quant=FP8, **budget)
        model = SlowFast(self.classes, self.depth).to(dev)
        model.load_state_dict(streams.stream_state_dict(
            self.classes, self.depth, streams.stream_seed(ctx.seed, 0), dev))
        spent = rec.notes.setdefault("check_s", {"detector": 0.0, "networks": 0.0})
        gaps = {"det_score_gap": 0.0, "box_gap": 0.0, "uv_gap": 0.0}
        # (off, all) of the chart's foreground pixels, the proposals, the detections
        shares = {"chart_off": [0, 0], "proposal_off": [0, 0], "detection_off": [0, 0]}
        seen = rec.notes.setdefault("detections", {"frames": 0, "valid": 0})
        pairs: Dict[str, list] = {"logp_gap": []}
        flow_pairs = []
        missing = False
        t0 = time.perf_counter()
        with strict_float32():
            for key in sample:
                if ctx.mode != "control" and key not in self.served:
                    missing = True
                    continue
                rgb_np, depth_np = traffic.videos[key]
                rgb, depth = torch.from_numpy(rgb_np).to(dev), torch.from_numpy(depth_np).to(dev)
                raw = self.detected(key[0])
                x = ref_det.images(pad2x(rgb[torch.from_numpy(raw).to(dev)]))
                t = time.perf_counter()
                got = (control(x) if ctx.mode == "control" else self.det_cap.of(key))
                numbers = judge_detector(detector, x, got)
                spent["detector"] += time.perf_counter() - t
                for k in gaps:
                    gaps[k] = max(gaps[k], numbers[k])
                for k, (off, n) in shares.items():
                    shares[k] = [off + numbers[k][0], n + numbers[k][1]]
                handed = handed_on(got)
                seen["frames"] += int(handed[1].numel())
                seen["valid"] += int(handed[1].sum())
                row = {int(r): i for i, r in enumerate(raw)}

                def detections_of(frames, handed=handed, row=row):
                    idx = torch.tensor([row[int(r)] for r in frames], device=dev)
                    return tuple(t[idx] for t in handed)

                flows: List[torch.Tensor] = []
                want = self._probs(model, given_crops.video_clips(
                    rgb, depth, [folder], detections_of, self.clip_len, self.interval, fp, spent,
                    flows, F32)[folder], FLOAT32, spent)
                if ctx.mode == "control":
                    theirs: List[torch.Tensor] = []
                    clips = given_crops.video_clips(rgb, depth, [folder], detections_of,
                                                    self.clip_len, self.interval, fp, spent,
                                                    theirs, BF16)[folder]
                    probs = self._probs(model, clips, FP8, spent)
                    video = probs.mean(0)
                    flow_pairs += list(zip(theirs, flows))
                else:
                    probs = torch.as_tensor(np.asarray(self.served[key]["clips"][self.names[0]]))
                    video = torch.as_tensor(np.asarray(self.served[key]["probs"]))
                    flow_pairs += [(self.cap.flows[self.cap.slots[(key, self.names[0], w)]][1:], f)
                                   for w, f in enumerate(flows)]
                pairs["logp_gap"] += [(probs, want), (probs.mean(0), want.mean(0)),
                                      (video, want.mean(0))]
        rec.check_s = time.perf_counter() - t0
        rec.numbers = check.serve_numbers(pairs)
        rec.numbers["flow_off"] = check.flow_off(flow_pairs)
        rec.numbers.update(gaps)
        for k, (off, n) in shares.items():
            rec.numbers[k] = off / n if n else 0.0
        seen.update(chart_foreground_px=shares["chart_off"][1],
                    proposals=shares["proposal_off"][1], detections=shares["detection_off"][1])
        if missing:     # a sampled video that no request of the window answered
            rec.numbers["logp_gap"] = math.inf
        rec.sampled = len(sample)
        if self.detect_flop is not None:
            rec.notes["detect_flop"] = self.detect_flop

    @staticmethod
    def _probs(model, clips, quant, spent):
        t = time.perf_counter()
        model.set_quant(quant)
        out = ref.clip_probs(model, clips).cpu()
        model.set_quant(FLOAT32)
        spent["networks"] += time.perf_counter() - t
        return out


def unmatched(a: torch.Tensor, a_ok: torch.Tensor, b: torch.Tensor, b_ok: torch.Tensor,
              tol: torch.Tensor) -> Tuple[int, int]:
    """(rows of either side with no row of the other within ``tol`` in every
    column, rows) of the rows ``a`` (B, N, K) where ``a_ok`` (B, N) and ``b``
    (B, M, K) where ``b_ok``, frame by frame: a set match, so that one
    choice taken otherwise counts once, not once for every slot after it."""
    near = ((a[:, :, None] - b[:, None]).abs() <= tol).all(dim=-1)
    near &= a_ok[:, :, None] & b_ok[:, None, :]
    lost = (a_ok & ~near.any(dim=2)).sum() + (b_ok & ~near.any(dim=1)).sum()
    return int(lost), int(a_ok.sum() + b_ok.sum())


def judge_detector(detector: ref_det.DensePose, x: torch.Tensor, got: Dict) -> Dict:
    """The reference ``detector`` on what ``got`` (the program's capture, or
    the control's detector) computed for the frames ``x``: its proposals
    from ``got``'s RPN head outputs, its detections from ``got``'s
    proposals and box head outputs, its box head and chart branch on
    ``got``'s proposals and best box. Returns ``det_score_gap``,
    ``box_gap``, ``uv_gap`` and the (off, all) counts of ``proposal_off``,
    ``detection_off`` and ``chart_off`` (foreground pixels)."""
    h, w = x.shape[-2:]
    px = torch.full((4,), PROPOSAL_PX, device=x.device)
    proposals, kept = detector.proposals_of(got["rpn"], h, w)
    out = {"proposal_off": unmatched(got["proposals"], got["kept"], proposals, kept, px)}
    det = detector.detections(got["proposals"], got["kept"], got["cls"], got["deltas"], h, w)
    tol = torch.cat([px, torch.full((1,), SCORE_TOL, device=x.device)])
    out["detection_off"] = unmatched(
        torch.cat([got["boxes"], got["scores"][..., None]], dim=-1), got["valid"],
        torch.cat([det["boxes"], det["scores"][..., None]], dim=-1), det["valid"], tol)
    feats = detector.features(x)
    cls, deltas = detector.box_outputs(feats, got["proposals"])
    b, p = cls.shape[:2]
    # The scores as the program computes them (softmax of (B x P, 2) logits),
    # so that the best detection's score is one of them bit for bit.
    mine, theirs = detector.person(cls), detector.person(got["cls"].reshape(b * p, 2)).reshape(b, p)
    out["det_score_gap"] = float((mine - theirs).abs().max())
    # A valid best detection came from the first proposal of its score (the
    # greedy NMS's first pick); an invalid one means no proposal scored
    # above the threshold.
    best = torch.argmax(got["scores"], dim=1)
    rows = torch.arange(b, device=x.device)
    top, valid = got["scores"][rows, best], got["valid"][rows, best]
    hit = theirs == top[:, None]
    source = torch.argmax(hit.int(), dim=1)
    box = ref_det.clip(ref_det.decode(got["proposals"][rows, source], deltas[rows, source],
                                      ref_det.BOX_WEIGHTS), h, w)
    gap = torch.where(valid, (box - got["boxes"][rows, best]).abs().amax(dim=1), 0.0)
    above = mine > ref_det.SCORE_THRESHOLD
    agree = torch.where(valid, hit.any(dim=1) & above[rows, source], ~above.any(dim=1))
    out["box_gap"] = float(torch.where(agree, gap, math.inf).max())
    charts, u, v = detector.charts(feats, got["boxes"][rows, best][:, None])
    mine_c, theirs_c = charts[:, 0], got["charts"][:, 0].long()
    fg = (mine_c > 0) | (theirs_c > 0)
    same = mine_c == theirs_c
    out["chart_off"] = (int((fg & ~same).sum()), int(fg.sum()))
    uv = torch.stack([u[:, 0] - got["u"][:, 0], v[:, 0] - got["v"][:, 0]]).abs()
    out["uv_gap"] = float(uv[:, same].max()) if bool(same.any()) else 0.0
    return out


def serve(ctx: Context) -> Serving:
    return Serving(ctx)


# ---- faults -----------------------------------------------------------------

def chart_second(pred, streams_) -> None:
    """The crops get the chart and U/V of the second detection with the best
    one's box."""
    model = pred._detector.model
    model.chart_topk = 2
    forward = model.forward

    def second(images):
        out = forward(images)
        return dict(out, charts=out["charts"][:, 1:], u=out["u"][:, 1:], v=out["v"][:, 1:])

    model.forward = second


def box_deltas_dropped(pred, streams_) -> None:
    """The box head's deltas read zero: each detection is its proposal."""
    layer = pred._detector.model.roi_heads["box_predictor"].bbox_pred
    with torch.no_grad():
        layer.weight.zero_()
        layer.bias.zero_()


def _nms_threshold(pred, method: str, threshold: float) -> None:
    """The detector's ``method`` (``_proposals`` or ``_detections``) runs its
    NMS at ``threshold``."""
    from video_classification_tpu_torch.detect import densepose as program

    model = pred._detector.model
    step = getattr(model, method)

    def at_threshold(*args):
        nms = program.nms
        program.nms = lambda boxes, scores, max_out, _thr: nms(boxes, scores, max_out, threshold)
        try:
            return step(*args)
        finally:
            program.nms = nms

    setattr(model, method, at_threshold)


def rpn_nms_off(pred, streams_) -> None:
    """The RPN's NMS (the first K3) suppresses nothing: IoU threshold 1."""
    _nms_threshold(pred, "_proposals", 1.0)


def box_nms_off(pred, streams_) -> None:
    """The box stage's NMS (the second K3) suppresses nothing."""
    _nms_threshold(pred, "_detections", 1.0)


FAULTS = {"serve": dict(streams.FAULTS["serve"], chart_second=chart_second,
                        box_deltas_dropped=box_deltas_dropped, rpn_nms_off=rpn_nms_off,
                        box_nms_off=box_nms_off)}
