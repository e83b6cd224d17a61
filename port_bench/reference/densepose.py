"""Plain PyTorch DensePose R-CNN R101-FPN-DL (reference copy).

The detector of Güler et al., *DensePose: Dense Human Pose Estimation in the
Wild* (arXiv:1802.00434), as detectron2's
``projects/DensePose/configs/densepose_rcnn_R_101_FPN_DL_s1x.yaml`` builds
it, written as float32 equations over a state dict in detectron2's names
(``backbone.bottom_up.res4.3.conv2.norm.running_var``,
``roi_heads.densepose_head.ASPP.convs.2.0.weight``, ...), so one state dict
loads here and into the program under test:

  * ResNet (MSRA: the stride on the first 1x1 of a stage's first block,
    frozen BatchNorm) and an FPN of 256 channels over P2..P5, nearest
    top-down, plus P6 as a stride-2 subsample of P5;
  * the RPN: a shared 3x3 conv + ReLU, 3 anchors a position (sizes 32..512
    by level, ratios 0.5, 1, 2, centred on cell corners), per level the
    ``pre_nms_topk`` best objectness logits, their boxes decoded and clipped
    to the frame, one greedy NMS at IoU 0.7 over all levels that never
    suppresses across levels, ``post_nms_topk`` proposals;
  * the box head: a 7x7 ROIAlign (aligned, 2x2 samples a bin) of each
    proposal on its FPN level, two 1024-wide FC + ReLU, the person score
    (softmax column 0) and its box deltas (weights 10, 10, 5, 5); scores of
    at most 0.05 count as no detection, greedy NMS at 0.5, the first
    ``max_detections``;
  * the DensePose branch: the decoder (per level max(1, l) 3x3 conv + ReLU
    + 2x bilinear upsample, summed at stride 4, a 1x1 conv), a 28x28
    ROIAlign of the chart boxes at 1/4, the DeepLab head (ASPP at rates 6,
    12, 56 with an image-pooling branch, each GroupNorm(32) + ReLU, a 1x1
    projection + ReLU, then 8 bias-free 3x3 convs 512 wide, GroupNorm(32),
    ReLU), the chart predictor (4x4 stride-2 transposed convs for the
    coarse mask, 25 charts, U and V, then 2x bilinear: 112x112), the part
    I = argmax(fine) where argmax(coarse) > 0, and U, V of that chart,
    clamped to [0, 1].

Departures from detectron2, shared with the serving path under test: top-k
keeps the lower index first among equal scores (the zero padding of a frame
makes many), NMS keeps levels apart by offsetting each level's boxes by
(level x (max(H, W) + 2)), no empty proposal is dropped, a score at most
0.05 stays in the NMS at 0 (it can only fill a slot after every live
detection, as an invalid one), ROIAlign clamps its sample coordinates to the
map and its base corner to (H - 2, W - 2), and GroupNorm takes its variance
as E[x^2] - E[x]^2 (the same function as torch's in exact arithmetic).

Every operation is a plain float32 ``torch`` call (``F.conv2d``,
``F.linear``, gathers, a Python loop for the greedy NMS); TF32 is off in
every public method (``precision.strict_float32``). ``quant`` (a
``slowfast.Quant``) rounds the operands of every convolution and linear
layer: the control of the correctness check (``precision.FP8``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .precision import strict_float32

STAGES = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
FPN = 256
BOX_HIDDEN = 1024
HEAD_HIDDEN = 512
HEAD_CONVS = 8
ASPP_RATES = (6, 12, 56)
CHARTS = 25                        # background and the 24 body charts
STRIDES = (4, 8, 16, 32, 64)
ANCHOR_SIZES = (32.0, 64.0, 128.0, 256.0, 512.0)
RATIOS = (0.5, 1.0, 2.0)
BOX_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
SCALE_CLAMP = math.log(1000.0 / 16)
SCORE_THRESHOLD = 0.05
PIXEL_MEAN = (103.53, 116.28, 123.675)   # BGR, detectron2's caffe2 backbones
BN_EPS = 1e-5
GN_EPS = 1e-5


# ---- the state dict's layout ----------------------------------------------

def layout(depth: int = 101) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """{name: (shape, kind)} of every tensor, kind one of 'conv', 'deconv',
    'linear' (weights), 'bias', 'scale' (a norm's weight, BatchNorm's
    running variance) and 'shift' (a norm's bias, BatchNorm's running
    mean)."""
    out: Dict[str, Tuple[Tuple[int, ...], str]] = {}

    def conv(name, cin, cout, k, bias=False, norm=None, norm_name=None):
        out[name + ".weight"] = ((cout, cin, k, k), "conv")
        if bias:
            out[name + ".bias"] = ((cout,), "bias")
        leaves = {"bn": (("weight", "scale"), ("bias", "shift"),
                         ("running_mean", "shift"), ("running_var", "scale")),
                  "gn": (("weight", "scale"), ("bias", "shift")),
                  None: ()}[norm]
        for leaf, kind in leaves:
            out[f"{norm_name or name + '.norm'}.{leaf}"] = ((cout,), kind)

    bu = "backbone.bottom_up"
    conv(f"{bu}.stem.conv1", 3, 64, 7, norm="bn")
    cin, inner, cout = 64, 64, 256
    for s, n in enumerate(STAGES[depth]):
        for j in range(n):
            p = f"{bu}.res{s + 2}.{j}"
            if j == 0:
                conv(p + ".shortcut", cin, cout, 1, norm="bn")
            conv(p + ".conv1", cin if j == 0 else cout, inner, 1, norm="bn")
            conv(p + ".conv2", inner, inner, 3, norm="bn")
            conv(p + ".conv3", inner, cout, 1, norm="bn")
        cin, inner, cout = cout, inner * 2, cout * 2
    for lvl, c in zip((2, 3, 4, 5), (256, 512, 1024, 2048)):
        conv(f"backbone.fpn_lateral{lvl}", c, FPN, 1, bias=True)
        conv(f"backbone.fpn_output{lvl}", FPN, FPN, 3, bias=True)
    rpn = "proposal_generator.rpn_head"
    conv(rpn + ".conv", FPN, FPN, 3, bias=True)
    conv(rpn + ".objectness_logits", FPN, len(RATIOS), 1, bias=True)
    conv(rpn + ".anchor_deltas", FPN, 4 * len(RATIOS), 1, bias=True)
    for name, cin_, cout_ in (("box_head.fc1", FPN * 49, BOX_HIDDEN),
                              ("box_head.fc2", BOX_HIDDEN, BOX_HIDDEN),
                              ("box_predictor.cls_score", BOX_HIDDEN, 2),
                              ("box_predictor.bbox_pred", BOX_HIDDEN, 4)):
        out[f"roi_heads.{name}.weight"] = ((cout_, cin_), "linear")
        out[f"roi_heads.{name}.bias"] = ((cout_,), "bias")
    for lvl in range(4):
        for i in range(max(1, lvl)):
            conv(f"roi_heads.decoder.p{lvl + 2}.{2 * i}", FPN, FPN, 3, bias=True)
    conv("roi_heads.decoder.predictor", FPN, FPN, 1, bias=True)
    aspp = "roi_heads.densepose_head.ASPP"
    for i, k in enumerate((1, 3, 3, 3)):
        conv(f"{aspp}.convs.{i}.0", FPN, FPN, k, norm="gn", norm_name=f"{aspp}.convs.{i}.1")
    conv(f"{aspp}.convs.4.1", FPN, FPN, 1, norm="gn", norm_name=f"{aspp}.convs.4.2")
    conv(f"{aspp}.project.0", FPN * (len(ASPP_RATES) + 2), FPN, 1)
    c = FPN
    for i in range(HEAD_CONVS):
        conv(f"roi_heads.densepose_head.body_conv_fcn{i + 1}", c, HEAD_HIDDEN, 3, norm="gn")
        c = HEAD_HIDDEN
    for name, ch in (("ann_index_lowres", 2), ("index_uv_lowres", CHARTS),
                     ("u_lowres", CHARTS), ("v_lowres", CHARTS)):
        out[f"roi_heads.densepose_predictor.{name}.weight"] = ((HEAD_HIDDEN, ch, 4, 4), "deconv")
        out[f"roi_heads.densepose_predictor.{name}.bias"] = ((ch,), "bias")
    return out


# ---- plain operations -----------------------------------------------------

def anchors(h: int, w: int, stride: int, size: float, device) -> torch.Tensor:
    """(h * w * 3, 4) xyxy anchors of one level in (y, x, ratio) order: a
    box of area size^2 and aspect h/w = ratio around each cell corner."""
    y = torch.arange(h, dtype=torch.float32, device=device) * stride
    x = torch.arange(w, dtype=torch.float32, device=device) * stride
    half = torch.tensor([[size / math.sqrt(r) / 2, size * math.sqrt(r) / 2] for r in RATIOS],
                        device=device)                              # (3, 2): half w, half h
    cx = x[None, :, None].expand(h, w, len(RATIOS))
    cy = y[:, None, None].expand(h, w, len(RATIOS))
    return torch.stack([cx - half[:, 0], cy - half[:, 1], cx + half[:, 0], cy + half[:, 1]],
                       dim=-1).reshape(-1, 4)


def decode(boxes: torch.Tensor, deltas: torch.Tensor, weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """detectron2's ``Box2BoxTransform.apply_deltas`` on (..., 4) xyxy."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    dx, dy = deltas[..., 0] / weights[0], deltas[..., 1] / weights[1]
    dw = torch.clamp(deltas[..., 2] / weights[2], max=SCALE_CLAMP)
    dh = torch.clamp(deltas[..., 3] / weights[3], max=SCALE_CLAMP)
    pcx, pcy = dx * w + cx, dy * h + cy
    pw, ph = torch.exp(dw) * w, torch.exp(dh) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1)


def clip(boxes: torch.Tensor, h: int, w: int) -> torch.Tensor:
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([x1.clamp(0, w), y1.clamp(0, h), x2.clamp(0, w), y2.clamp(0, h)], dim=-1)


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, max_out: int,
               threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N, 4) boxes, (B, N) scores -> (index (B, max_out) int64, kept
    (B, max_out) bool): repeatedly the live box of the highest score (the
    lowest index among equal ones) is kept and it and every live box whose
    IoU with it exceeds ``threshold`` are removed; a slot left when no box
    is live is index 0, not kept."""
    b, n = scores.shape
    dev = scores.device
    area = ((boxes[..., 2] - boxes[..., 0]).clamp(min=0)
            * (boxes[..., 3] - boxes[..., 1]).clamp(min=0))
    live = torch.ones((b, n), dtype=torch.bool, device=dev)
    index = torch.zeros((b, max_out), dtype=torch.int64, device=dev)
    kept = torch.zeros((b, max_out), dtype=torch.bool, device=dev)
    frames = torch.arange(b, device=dev)
    for slot in range(max_out):
        masked = torch.where(live, scores, torch.full_like(scores, -math.inf))
        best = torch.argmax(masked, dim=1)
        ok = live[frames, best]
        index[:, slot] = torch.where(ok, best, torch.zeros_like(best))
        kept[:, slot] = ok
        top = boxes[frames, best][:, None, :]                          # (B, 1, 4)
        iw = (torch.minimum(boxes[..., 2], top[..., 2]) - torch.maximum(boxes[..., 0], top[..., 0]))
        ih = (torch.minimum(boxes[..., 3], top[..., 3]) - torch.maximum(boxes[..., 1], top[..., 1]))
        inter = iw.clamp(min=0) * ih.clamp(min=0)
        iou = inter / (area + area[frames, best][:, None] - inter).clamp(min=1e-9)
        gone = (iou > threshold) | (torch.arange(n, device=dev)[None, :] == best[:, None])
        live &= ~(gone & ok[:, None])
    return index, kept


def bilinear(feat: torch.Tensor, frame: torch.Tensor, y: torch.Tensor, x: torch.Tensor
             ) -> torch.Tensor:
    """Samples of ``feat`` (B, C, H, W) at (y, x) of frame ``frame`` (each
    (M, S, S)) -> (M, C, S, S): coordinates clamped to the map, the base
    corner to (H - 2, W - 2) (a weight of 1 then reads the last row or
    column)."""
    h, w = feat.shape[-2:]
    y = y.clamp(0, h - 1)
    x = x.clamp(0, w - 1)
    y0 = torch.floor(y).clamp(max=h - 2)
    x0 = torch.floor(x).clamp(max=w - 2)
    fy, fx = y - y0, x - x0
    y0, x0 = y0.long(), x0.long()
    f = feat.permute(0, 2, 3, 1)                                        # (B, H, W, C)

    def at(dy, dx):
        return f[frame, y0 + dy, x0 + dx]                              # (M, S, S, C)

    fy, fx = fy[..., None], fx[..., None]
    out = (at(0, 0) * (1 - fy) * (1 - fx) + at(0, 1) * (1 - fy) * fx
           + at(1, 0) * fy * (1 - fx) + at(1, 1) * fy * fx)
    return out.permute(0, 3, 1, 2)


def roi_align(feat: torch.Tensor, boxes: torch.Tensor, size: int, scale: float,
              ratio: int = 2) -> torch.Tensor:
    """ROIAlign (aligned) of (B, N, 4) image boxes on one map (B, C, H, W) at
    ``scale`` -> (B, N, C, size, size): each bin the mean of ratio x ratio
    bilinear samples at its sub-cell centres."""
    b, n = boxes.shape[:2]
    flat = boxes.reshape(-1, 4).float() * scale
    frame = torch.arange(b, device=boxes.device).repeat_interleave(n)
    out = _pool(feat, flat, frame, size, ratio)
    return out.reshape(b, n, *out.shape[1:])


def _pool(feat, flat, frame, size, ratio):
    x1, y1, x2, y2 = flat.unbind(-1)
    bw = (x2 - x1).clamp(min=1e-6) / size
    bh = (y2 - y1).clamp(min=1e-6) / size
    t = (torch.arange(size * ratio, dtype=torch.float32, device=flat.device) + 0.5) / ratio
    ys = y1[:, None] + t[None, :] * bh[:, None] - 0.5                  # (M, S)
    xs = x1[:, None] + t[None, :] * bw[:, None] - 0.5
    s = size * ratio
    samples = bilinear(feat, frame[:, None, None].expand(-1, s, s),
                       ys[:, :, None].expand(-1, s, s), xs[:, None, :].expand(-1, s, s))
    m, c = samples.shape[:2]
    return samples.reshape(m, c, size, ratio, size, ratio).mean(dim=(3, 5))


def level_roi_align(feats: Sequence[torch.Tensor], boxes: torch.Tensor, size: int,
                    ratio: int = 2) -> torch.Tensor:
    """FPN ROIAlign of (B, N, 4) boxes over P2..P5 -> (B, N, C, size, size):
    a box pools on level floor(4 + log2(sqrt(area) / 224)) of 2..5
    (detectron2's ``assign_boxes_to_levels``, w and h floored at 1)."""
    b, n = boxes.shape[:2]
    flat = boxes.reshape(-1, 4).float()
    frame = torch.arange(b, device=boxes.device).repeat_interleave(n)
    side = torch.sqrt((flat[:, 2] - flat[:, 0]).clamp(min=1)
                      * (flat[:, 3] - flat[:, 1]).clamp(min=1))
    level = torch.floor(2 + torch.log2(side / 224 + 1e-8)).clamp(0, len(feats) - 1).long()
    out = torch.zeros((b * n, feats[0].shape[1], size, size), dtype=feats[0].dtype,
                      device=boxes.device)
    for lvl, feat in enumerate(feats):
        on = (level == lvl).nonzero()[:, 0]
        if on.numel():
            out[on] = _pool(feat, flat[on] / STRIDES[lvl], frame[on], size, ratio)
    return out.reshape(b, n, *out.shape[1:])


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


# ---- the detector -----------------------------------------------------------

class DensePose:
    """The detector over a float32 state dict ``state`` (names and shapes of
    ``layout(depth)``). ``__call__`` runs it whole; its parts are public so
    that the check can run the reference's box head and chart branch on the
    program's own proposals and boxes, and the FLOP count the dense parts on
    meta tensors."""

    def __init__(self, state: Dict[str, torch.Tensor], depth: int = 101,
                 pre_nms_topk: int = 1000, post_nms_topk: int = 1000,
                 max_detections: int = 100, chart_pooler_size: int = 28, quant=None):
        self.s = state
        self.depth = depth
        self.pre_nms_topk = pre_nms_topk
        self.post_nms_topk = post_nms_topk
        self.max_detections = max_detections
        self.pooler = chart_pooler_size
        self.quant = quant

    def _q(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.quant is None else self.quant.operand(t)

    def _conv(self, x, name, stride=1, padding=0, dilation=1):
        return F.conv2d(self._q(x), self._q(self.s[name + ".weight"]), self.s.get(name + ".bias"),
                        stride, padding, dilation)

    def _bn(self, x, name):
        inv = torch.rsqrt(self.s[name + ".running_var"] + BN_EPS) * self.s[name + ".weight"]
        shift = self.s[name + ".bias"] - self.s[name + ".running_mean"] * inv
        return x * inv[None, :, None, None] + shift[None, :, None, None]

    def _gn(self, x, name, groups=32):
        n, c = x.shape[:2]
        g = x.reshape(n, groups, c // groups, -1)
        mean = g.mean(dim=(2, 3), keepdim=True)
        var = ((g * g).mean(dim=(2, 3), keepdim=True) - mean * mean).clamp(min=0)
        g = (g - mean) * (torch.rsqrt(var + GN_EPS)
                          * self.s[name + ".weight"].reshape(1, groups, c // groups, 1))
        g = g + self.s[name + ".bias"].reshape(1, groups, c // groups, 1)
        return g.reshape(x.shape)

    def _linear(self, x, name):
        return F.linear(self._q(x), self._q(self.s[name + ".weight"]), self.s[name + ".bias"])

    def _conv_bn(self, x, name, stride=1, padding=0, relu=True):
        y = self._bn(self._conv(x, name, stride, padding), name + ".norm")
        return F.relu(y) if relu else y

    # -- dense parts --

    @strict_float32()
    def features(self, images: torch.Tensor) -> List[torch.Tensor]:
        """P2..P6 of (B, 3, H, W) mean-subtracted BGR images, each padded at
        the bottom and right to a multiple of 64 with zeros."""
        h, w = images.shape[-2:]
        x = F.pad(images, (0, -w % 64, 0, -h % 64))
        bu = "backbone.bottom_up"
        x = F.max_pool2d(self._conv_bn(x, f"{bu}.stem.conv1", 2, 3), 3, 2, 1)
        outs = []
        for s, n in enumerate(STAGES[self.depth]):
            for j in range(n):
                p = f"{bu}.res{s + 2}.{j}"
                stride = 2 if (s > 0 and j == 0) else 1
                short = self._conv_bn(x, p + ".shortcut", stride, relu=False) if j == 0 else x
                y = self._conv_bn(x, p + ".conv1", stride)
                y = self._conv_bn(y, p + ".conv2", 1, 1)
                x = F.relu(short + self._conv_bn(y, p + ".conv3", relu=False))
            outs.append(x)
        lat = [self._conv(c, f"backbone.fpn_lateral{i + 2}") for i, c in enumerate(outs)]
        top = [lat[3]]
        for i in (2, 1, 0):
            top.insert(0, lat[i] + F.interpolate(top[0], size=lat[i].shape[-2:], mode="nearest"))
        ps = [self._conv(p, f"backbone.fpn_output{i + 2}", padding=1) for i, p in enumerate(top)]
        return ps + [F.max_pool2d(ps[-1], 1, 2)]

    @strict_float32()
    def rpn_head(self, feats: Sequence[torch.Tensor]):
        """Per level (objectness (B, 3, H, W), deltas (B, 12, H, W))."""
        rpn = "proposal_generator.rpn_head"
        out = []
        for f in feats:
            t = F.relu(self._conv(f, rpn + ".conv", padding=1))
            out.append((self._conv(t, rpn + ".objectness_logits"),
                        self._conv(t, rpn + ".anchor_deltas")))
        return out

    @strict_float32()
    def box_head(self, rois: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(M, 256, 7, 7) pooled proposals -> (class logits (M, 2), box
        deltas (M, 4))."""
        x = F.relu(self._linear(rois.flatten(1), "roi_heads.box_head.fc1"))
        x = F.relu(self._linear(x, "roi_heads.box_head.fc2"))
        return (self._linear(x, "roi_heads.box_predictor.cls_score"),
                self._linear(x, "roi_heads.box_predictor.bbox_pred"))

    @strict_float32()
    def decoder(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        """The stride-4 DensePose features of P2..P5."""
        total = None
        for lvl, f in enumerate(feats[:4]):
            for i in range(max(1, lvl)):
                f = F.relu(self._conv(f, f"roi_heads.decoder.p{lvl + 2}.{2 * i}", padding=1))
                if lvl > 0:
                    f = upsample2x(f)
            total = f if total is None else total + f
        return self._conv(total, "roi_heads.decoder.predictor")

    @strict_float32()
    def chart_head(self, rois: torch.Tensor):
        """(M, 256, S, S) pooled chart boxes -> coarse (M, 2, 4S, 4S), fine,
        U and V (M, 25, 4S, 4S) logits."""
        aspp = "roi_heads.densepose_head.ASPP"
        branches = [F.relu(self._gn(self._conv(rois, f"{aspp}.convs.0.0"), f"{aspp}.convs.0.1"))]
        for i, r in enumerate(ASPP_RATES, start=1):
            y = self._conv(rois, f"{aspp}.convs.{i}.0", padding=r, dilation=r)
            branches.append(F.relu(self._gn(y, f"{aspp}.convs.{i}.1")))
        pooled = self._conv(rois.mean(dim=(2, 3), keepdim=True), f"{aspp}.convs.4.1")
        branches.append(F.relu(self._gn(pooled, f"{aspp}.convs.4.2")).expand_as(branches[0]))
        x = F.relu(self._conv(torch.cat(branches, dim=1), f"{aspp}.project.0"))
        for i in range(HEAD_CONVS):
            p = f"roi_heads.densepose_head.body_conv_fcn{i + 1}"
            x = F.relu(self._gn(self._conv(x, p, padding=1), p + ".norm"))
        pred = "roi_heads.densepose_predictor"
        return tuple(upsample2x(F.conv_transpose2d(
            self._q(x), self._q(self.s[f"{pred}.{n}.weight"]), self.s[f"{pred}.{n}.bias"], 2, 1))
            for n in ("ann_index_lowres", "index_uv_lowres", "u_lowres", "v_lowres"))

    # -- the steps between --

    @strict_float32()
    def proposals(self, feats: Sequence[torch.Tensor], h: int, w: int):
        """(proposals (B, P, 4), kept (B, P)) of a frame of h x w."""
        return self.proposals_of(self.rpn_head(feats), h, w)

    @strict_float32()
    def proposals_of(self, rpn: Sequence[Tuple[torch.Tensor, torch.Tensor]], h: int, w: int):
        """``proposals`` from the RPN head's outputs ``rpn`` (per level
        objectness (B, 3, H, W) and deltas (B, 12, H, W), of any float
        dtype): anchors, top-k, decoding, clipping and the NMS."""
        boxes, scores, levels = [], [], []
        for lvl, (obj, deltas) in enumerate(rpn):
            b, a, fh, fw = obj.shape
            obj = obj.float().permute(0, 2, 3, 1).reshape(b, -1)
            deltas = (deltas.float().reshape(b, a, 4, fh, fw).permute(0, 3, 4, 1, 2)
                      .reshape(b, -1, 4))
            k = min(self.pre_nms_topk, obj.shape[1])
            top, idx = torch.sort(obj, dim=1, descending=True, stable=True)
            top, idx = top[:, :k], idx[:, :k]
            anc = anchors(fh, fw, STRIDES[lvl], ANCHOR_SIZES[lvl], obj.device)[idx]
            rows = torch.arange(b, device=obj.device)[:, None]
            boxes.append(clip(decode(anc, deltas[rows, idx]), h, w))
            scores.append(top)
            levels.append(torch.full((k,), float(lvl), device=obj.device))
        boxes = torch.cat(boxes, dim=1)
        offset = torch.cat(levels)[:, None] * (float(max(h, w)) + 2.0)
        index, kept = greedy_nms(boxes + offset, torch.cat(scores, dim=1), self.post_nms_topk, 0.7)
        rows = torch.arange(boxes.shape[0], device=boxes.device)[:, None]
        return boxes[rows, index], kept

    @strict_float32()
    def box_outputs(self, feats: Sequence[torch.Tensor], proposals: torch.Tensor):
        """(class logits (B, P, 2), deltas (B, P, 4)) of (B, P, 4) proposals."""
        b, p = proposals.shape[:2]
        rois = level_roi_align(feats[:4], proposals, 7)
        cls, deltas = self.box_head(rois.reshape(b * p, *rois.shape[2:]))
        return cls.reshape(b, p, 2), deltas.reshape(b, p, 4)

    @staticmethod
    def person(cls: torch.Tensor) -> torch.Tensor:
        """The person score of class logits (..., 2): softmax column 0."""
        return torch.softmax(cls.float(), dim=-1)[..., 0]

    @strict_float32()
    def detections(self, proposals, kept, cls, deltas, h: int, w: int):
        """{'boxes' (B, D, 4), 'scores' (B, D), 'valid' (B, D), 'index'
        (B, D): the proposal each detection came from}, best first. The
        scores are the softmax of the (B x P, 2) logits, as the serving path
        takes it."""
        score = torch.where(kept, self.person(cls.reshape(-1, 2)).reshape(kept.shape),
                            torch.zeros(()))
        score = torch.where(score > SCORE_THRESHOLD, score, torch.zeros(()))
        boxes = clip(decode(proposals, deltas, BOX_WEIGHTS), h, w)
        index, taken = greedy_nms(boxes, score, self.max_detections, 0.5)
        rows = torch.arange(boxes.shape[0], device=boxes.device)[:, None]
        valid = taken & (score[rows, index] > SCORE_THRESHOLD)
        return {"boxes": boxes[rows, index], "scores": torch.where(valid, score[rows, index], 0.0),
                "valid": valid, "index": index}

    @strict_float32()
    def charts(self, feats: Sequence[torch.Tensor], boxes: torch.Tensor):
        """(charts (B, K, hm, hm) int64, u, v (B, K, hm, hm)) of (B, K, 4)
        chart boxes, hm = 4 x the pooler's size."""
        b, k = boxes.shape[:2]
        rois = roi_align(self.decoder(feats), boxes, self.pooler, 0.25)
        coarse, fine, u, v = self.chart_head(rois.reshape(b * k, *rois.shape[2:]))
        part = torch.where(coarse.argmax(1) > 0, fine.argmax(1), torch.zeros((), dtype=torch.long))
        hm = part.shape[-1]

        def field(t):
            return t.gather(1, part[:, None])[:, 0].clamp(0.0, 1.0).reshape(b, k, hm, hm)

        return part.reshape(b, k, hm, hm), field(u), field(v)

    @strict_float32()
    def __call__(self, images: torch.Tensor, chart_topk: int = 1) -> Dict[str, torch.Tensor]:
        """The whole detector on (B, 3, H, W) mean-subtracted BGR images:
        ``detections``' dict and the charts of the first ``chart_topk``,
        with the RPN head's outputs, the proposals, their mask and the box
        head's outputs."""
        h, w = images.shape[-2:]
        feats = self.features(images)
        rpn = self.rpn_head(feats)
        proposals, kept = self.proposals_of(rpn, h, w)
        cls, deltas = self.box_outputs(feats, proposals)
        out = self.detections(proposals, kept, cls, deltas, h, w)
        out["charts"], out["u"], out["v"] = self.charts(feats, out["boxes"][:, :chart_topk])
        out.update(rpn=rpn, proposals=proposals, kept=kept, cls=cls, deltas=deltas)
        return out


def images(padded_bgr: torch.Tensor) -> torch.Tensor:
    """(S, H, W, 3) uint8 BGR frames -> (S, 3, H, W) float32, mean-subtracted."""
    mean = torch.tensor(PIXEL_MEAN, device=padded_bgr.device)
    return (padded_bgr.float() - mean).permute(0, 3, 1, 2).contiguous()
