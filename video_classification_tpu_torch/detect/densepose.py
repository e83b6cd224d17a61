"""DensePose R-CNN (``densepose_rcnn_R_101_FPN_DL_s1x``) as batched modules.

Port of the JAX package's ``detect/densepose.py``. The JAX package maps a
single-image graph over frames; here every module takes a (B, C, H, W) batch
and every step after the backbone is batched per frame, so a frame's result
does not depend on the batch it came in. Submodules carry detectron2's
state_dict names (``backbone.bottom_up.res4.3.conv2.norm``,
``proposal_generator.rpn_head.objectness_logits``, ``roi_heads.box_head.fc1``,
``roi_heads.densepose_head.ASPP.convs.2.0``, ...), so a released checkpoint
loads by name (``detect/d2_convert.py``).

  * ResNet (stride-in-1x1 bottlenecks, frozen BN) + FPN P2..P5 and a P6
    stride-2 subsample for the RPN.
  * RPN: shared 3x3 head over 5 levels, anchors 32..512 at ratios
    (0.5, 1, 2) on cell corners, per-level top-k (stable: lower index first
    on ties, as jax.lax.top_k), one NMS (kernel K3) over level-offset boxes.
  * Box head: 7x7 multi-level ROIAlign, 2 FC, person score (softmax column
    0, background last) and box deltas decoded with weights (10, 10, 5, 5);
    score threshold, NMS 0.5 (K3).
  * DensePose branch: decoder (stride-4 sum of per-level heads) -> ROIAlign
    of the kept boxes -> DeepLab head (ASPP 6/12/56 + 8 GroupNorm convs) ->
    chart predictor (4x4/2 deconvs + 2x bilinear) -> per-pixel part labels
    I = argmax(fine) where argmax(coarse) > 0, and the U/V of that chart.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import (BatchNorm, Conv2d, ConvTranspose2d, GroupNorm,
                             Linear, conv2d)
from ..models.resnet2d import Bottleneck2d
from .ops import (apply_deltas, clip_boxes, multilevel_roi_align, nms,
                  roi_align, top_k)

NUM_CHARTS = 24  # DensePose body charts 1..24; 0 = background
RESNET_DEPTHS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
# detectron2 Box2BoxTransform weights (Base-RCNN-FPN defaults).
RPN_DELTA_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
BOX_DELTA_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
FPN_STRIDES = (4, 8, 16, 32, 64)
ANCHOR_SIZES = (32.0, 64.0, 128.0, 256.0, 512.0)
NUM_ANCHORS = 3  # aspect ratios (0.5, 1, 2) per position
FPN_CHANNELS = 256
BOX_HIDDEN = 1024
HEAD_HIDDEN = 512  # DeepLab chart head width
HEAD_CONVS = 8
ASPP_RATES = (6, 12, 56)
SCORE_THRESHOLD = 0.05


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample, align_corners=False (as jax.image.resize)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


class Upsample2x(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample2x(x)


class BasicStem(nn.Module):
    """7x7/2 conv + frozen BN + ReLU, then 3x3/2 max pool (padding 1)."""

    def __init__(self):
        super().__init__()
        self.conv1 = conv2d(3, 64, 7, 2, norm=BatchNorm(64), relu=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(self.conv1(x), 3, 2, 1)


class ResNet(nn.Module):
    """The bottom-up ResNet: stem and stages res2..res5 of bottlenecks;
    returns the four stage outputs (strides 4..32)."""

    def __init__(self, depth: int = 101):
        super().__init__()
        self.stem = BasicStem()
        in_ch, dim_inner, dim_out = 64, 64, 256
        for stage, d in enumerate(RESNET_DEPTHS[depth]):
            blocks = []
            for j in range(d):
                blocks.append(Bottleneck2d(
                    in_ch if j == 0 else dim_out, dim_inner, dim_out,
                    stride=2 if (stage > 0 and j == 0) else 1,
                    use_downsample=(j == 0), stride_in_1x1=True))
            setattr(self, f"res{stage + 2}", nn.Sequential(*blocks))
            in_ch, dim_inner, dim_out = dim_out, dim_inner * 2, dim_out * 2

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.stem(x)
        outs = []
        for stage in range(2, 6):
            x = getattr(self, f"res{stage}")(x)
            outs.append(x)
        return outs


class ResNetFPN(nn.Module):
    """ResNet + FPN: P2..P5 (strides 4..32) and P6 (stride-2 subsample of
    P5, detectron2's LastLevelMaxPool); nearest top-down, biased 1x1
    laterals and 3x3 outputs."""

    def __init__(self, depth: int = 101):
        super().__init__()
        self.bottom_up = ResNet(depth)
        for lvl, cin in zip((2, 3, 4, 5), (256, 512, 1024, 2048)):
            setattr(self, f"fpn_lateral{lvl}",
                    conv2d(cin, FPN_CHANNELS, 1, bias=True))
            setattr(self, f"fpn_output{lvl}",
                    conv2d(FPN_CHANNELS, FPN_CHANNELS, 3, bias=True))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        laterals = [getattr(self, f"fpn_lateral{i + 2}")(c)
                    for i, c in enumerate(self.bottom_up(x))]
        ps = [laterals[-1]]
        for lat in laterals[-2::-1]:
            ps.insert(0, lat + F.interpolate(ps[0], size=lat.shape[-2:],
                                             mode="nearest"))
        ps = [getattr(self, f"fpn_output{i + 2}")(p) for i, p in enumerate(ps)]
        return ps + [F.max_pool2d(ps[-1], 1, 2)]


class RPNHead(nn.Module):
    """Shared 3x3 conv + ReLU -> per-anchor objectness and box deltas."""

    def __init__(self):
        super().__init__()
        c = FPN_CHANNELS
        self.conv = conv2d(c, c, 3, bias=True, relu=True)
        self.objectness_logits = conv2d(c, NUM_ANCHORS, 1, bias=True)
        self.anchor_deltas = conv2d(c, NUM_ANCHORS * 4, 1, bias=True)

    def forward(self, feats: Sequence[torch.Tensor]):
        out = []
        for f in feats:
            t = self.conv(f)
            out.append((self.objectness_logits(t), self.anchor_deltas(t)))
        return out


class BoxHead(nn.Module):
    """(M, C, 7, 7) ROIs, flattened channels-first -> 2 FC + ReLU."""

    def __init__(self):
        super().__init__()
        self.fc1 = Linear(FPN_CHANNELS * 7 * 7, BOX_HIDDEN)
        self.fc2 = Linear(BOX_HIDDEN, BOX_HIDDEN)

    def forward(self, rois: torch.Tensor) -> torch.Tensor:
        return F.relu(self.fc2(F.relu(self.fc1(rois.flatten(1)))))


class BoxPredictor(nn.Module):
    """detectron2 FastRCNNOutputLayers: (person, background) logits and a
    class-specific box delta."""

    def __init__(self):
        super().__init__()
        self.cls_score = Linear(BOX_HIDDEN, 2)
        self.bbox_pred = Linear(BOX_HIDDEN, 4)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.cls_score(x), self.bbox_pred(x)


class Decoder(nn.Module):
    """Panoptic-FPN semantic head over P2..P5: per level max(1, l) of
    [3x3 conv + ReLU (+ 2x bilinear upsample above P2)], summed at stride 4,
    then a 1x1 predictor. Level heads are ``p2..p5`` (Sequentials, so the
    convs sit at detectron2's indices 0, 2, 4)."""

    def __init__(self):
        super().__init__()
        c = FPN_CHANNELS  # input, conv and output (DECODER_NUM_CLASSES) widths
        for lvl in range(4):
            layers: List[nn.Module] = []
            for _ in range(max(1, lvl)):
                layers.append(conv2d(c, c, 3, bias=True, relu=True))
                if lvl > 0:
                    layers.append(Upsample2x())
            setattr(self, f"p{lvl + 2}", nn.Sequential(*layers))
        self.predictor = conv2d(c, c, 1, bias=True)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        total = None
        for lvl, f in enumerate(feats):
            x = getattr(self, f"p{lvl + 2}")(f)
            total = x if total is None else total + x
        return self.predictor(total)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: 1x1, three dilated 3x3 and an image
    pooling branch, each bias-free conv + GroupNorm(32) + ReLU,
    concatenated and projected by a bias-free 1x1 + ReLU."""

    def __init__(self, channels: int = FPN_CHANNELS):
        super().__init__()
        c = channels

        def branch(*convs):
            return nn.Sequential(*convs, GroupNorm(32, c), nn.ReLU())

        self.convs = nn.ModuleList(
            [branch(Conv2d(c, c, 1, bias=False))]
            + [branch(Conv2d(c, c, 3, padding=r, dilation=r, bias=False))
               for r in ASPP_RATES]
            + [branch(nn.AdaptiveAvgPool2d(1), Conv2d(c, c, 1, bias=False))])
        self.project = nn.Sequential(
            Conv2d(c * (len(ASPP_RATES) + 2), c, 1, bias=False), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [conv(x) for conv in self.convs]
        outs[-1] = outs[-1].expand_as(outs[0])
        return self.project(torch.cat(outs, dim=1))


class DensePoseDeepLabHead(nn.Module):
    """ASPP + 8 bias-free 3x3 GroupNorm(32) convs + ReLU, 512 wide."""

    def __init__(self):
        super().__init__()
        self.ASPP = ASPP()
        ch = FPN_CHANNELS
        for i in range(HEAD_CONVS):
            setattr(self, f"body_conv_fcn{i + 1}", conv2d(
                ch, HEAD_HIDDEN, 3, norm=GroupNorm(32, HEAD_HIDDEN), relu=True))
            ch = HEAD_HIDDEN

    def forward(self, rois: torch.Tensor) -> torch.Tensor:
        x = self.ASPP(rois)
        for i in range(HEAD_CONVS):
            x = getattr(self, f"body_conv_fcn{i + 1}")(x)
        return x


class ChartPredictor(nn.Module):
    """Coarse fg/bg (2), fine chart (25) and per-chart U and V logits, each
    ConvTranspose2d(4, 2, 1) from S to 2S, then 2x bilinear to 4S."""

    def __init__(self):
        super().__init__()
        for name, ch in (("ann_index_lowres", 2),
                         ("index_uv_lowres", NUM_CHARTS + 1),
                         ("u_lowres", NUM_CHARTS + 1),
                         ("v_lowres", NUM_CHARTS + 1)):
            setattr(self, name, ConvTranspose2d(HEAD_HIDDEN, ch, 4, stride=2,
                                                padding=1))

    def forward(self, x: torch.Tensor):
        return tuple(upsample2x(getattr(self, n)(x)) for n in
                     ("ann_index_lowres", "index_uv_lowres", "u_lowres", "v_lowres"))


def generate_anchors(hw: Tuple[int, int], stride: int, scale: float,
                     ratios=(0.5, 1.0, 2.0), device=None) -> torch.Tensor:
    """(H*W*A, 4) xyxy anchors of one level, in (H, W, A) order.

    detectron2 DefaultAnchorGenerator: [-w/2, -h/2, w/2, h/2] with
    w = scale/sqrt(r), h = scale*sqrt(r), shifted by x*stride (offset 0: the
    anchor centres sit on cell corners)."""
    h, w = hw
    cy = torch.arange(h, dtype=torch.float32, device=device) * stride
    cx = torch.arange(w, dtype=torch.float32, device=device) * stride
    anchors = []
    for r in ratios:
        aw = scale * (r ** -0.5)
        ah = scale * (r ** 0.5)
        a = torch.stack(torch.broadcast_tensors(
            cx[None, :] - aw / 2, cy[:, None] - ah / 2,
            cx[None, :] + aw / 2, cy[:, None] + ah / 2), dim=-1)  # (H, W, 4)
        anchors.append(a)
    return torch.stack(anchors, dim=2).reshape(-1, 4)


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t (B, N, ...) gathered at idx (B, K) along N -> (B, K, ...)."""
    return t[torch.arange(t.shape[0], device=t.device)[:, None], idx.long()]


class DensePoseRCNN(nn.Module):
    """End-to-end batched inference graph with static proposal and detection
    counts. Defaults are detectron2's test budget (1000 per level, 1000,
    100, chart pooler 28 -> heatmap 112; person score threshold 0.05);
    ``chart_topk`` > 0 runs the chart branch for only the best K detections
    (keep order is score-descending).

    Weights are float32; ``compute_dtype`` is the activation dtype."""

    def __init__(self, depth: int = 101, pre_nms_topk: int = 1000,
                 post_nms_topk: int = 1000, max_detections: int = 100,
                 chart_pooler_size: int = 28, chart_topk: int = 0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pre_nms_topk = pre_nms_topk
        self.post_nms_topk = post_nms_topk
        self.max_detections = max_detections
        self.chart_pooler_size = chart_pooler_size
        self.chart_topk = chart_topk
        self.compute_dtype = compute_dtype
        self.backbone = ResNetFPN(depth)
        self.proposal_generator = nn.ModuleDict({"rpn_head": RPNHead()})
        self.roi_heads = nn.ModuleDict({
            "box_head": BoxHead(), "box_predictor": BoxPredictor(),
            "decoder": Decoder(), "densepose_head": DensePoseDeepLabHead(),
            "densepose_predictor": ChartPredictor()})

    @property
    def heatmap_size(self) -> int:
        return self.chart_pooler_size * 4  # deconv 2x + interp 2x

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images: (B, 3, H, W) float32, BGR, mean-subtracted. Returns
        boxes (B, D, 4), scores (B, D), valid (B, D), and charts (int32,
        0..24), u, v (B, K, hm, hm) for the first K detections."""
        b, _, h, w = images.shape
        dev = images.device
        # Pad bottom-right to the backbone's size divisibility (64 with P6),
        # as detectron2's ImageList does; boxes clip to the true (h, w).
        x = F.pad(images, (0, -w % 64, 0, -h % 64)).to(self.compute_dtype)
        feats = self.backbone(x)  # [P2..P6]

        # RPN: score anchors, top-k per level, decode, one NMS over
        # level-offset boxes (detectron2 batched_nms: disjoint coordinate
        # ranges keep levels apart).
        boxes, scores, levels = [], [], []
        rpn_out = self.proposal_generator["rpn_head"](feats)
        for lvl, ((obj, deltas), stride, size) in enumerate(
                zip(rpn_out, FPN_STRIDES, ANCHOR_SIZES)):
            fh, fw = obj.shape[-2:]
            anchors = generate_anchors((fh, fw), stride, size, device=dev)
            obj = obj.permute(0, 2, 3, 1).reshape(b, -1).float()   # (H, W, A)
            deltas = (deltas.reshape(b, -1, 4, fh, fw).permute(0, 3, 4, 1, 2)
                      .reshape(b, -1, 4).float())                # (H, W, A, 4)
            k = min(self.pre_nms_topk, obj.shape[1])
            top_scores, top_idx = top_k(obj, k)
            decoded = apply_deltas(anchors[top_idx], _rows(deltas, top_idx),
                                   weights=RPN_DELTA_WEIGHTS)
            boxes.append(clip_boxes(decoded, (h, w)))
            scores.append(top_scores)
            levels.append(torch.full((k,), float(lvl), device=dev))
        boxes = torch.cat(boxes, dim=1)
        scores = torch.cat(scores, dim=1)
        offset = torch.cat(levels)[:, None] * (float(max(h, w)) + 2.0)
        keep_idx, proposal_mask = nms(boxes + offset, scores,
                                      self.post_nms_topk, 0.7)
        proposals = _rows(boxes, keep_idx)                        # (B, P, 4)

        # Box head on multi-level ROIAlign over P2..P5.
        p = proposals.shape[1]
        rois = multilevel_roi_align(feats[:4], proposals, 7)
        cls_scores, box_deltas = self.roi_heads["box_predictor"](
            self.roi_heads["box_head"](rois.reshape(b * p, *rois.shape[2:])))
        # detectron2 convention: background logit last; person = column 0.
        person = torch.softmax(cls_scores.float(), dim=-1)[:, 0].reshape(b, p)
        person = torch.where(proposal_mask, person, 0.0)
        det_boxes = clip_boxes(apply_deltas(
            proposals, box_deltas.float().reshape(b, p, 4),
            weights=BOX_DELTA_WEIGHTS), (h, w))
        person = torch.where(person > SCORE_THRESHOLD, person, 0.0)
        det_idx, det_mask = nms(det_boxes, person, self.max_detections, 0.5)
        final_boxes = _rows(det_boxes, det_idx)
        final_scores = _rows(person, det_idx)
        det_mask = det_mask & (final_scores > SCORE_THRESHOLD)

        # DensePose branch on the first chart_topk (best) detections.
        chart_boxes = final_boxes
        if self.chart_topk and self.chart_topk < final_boxes.shape[1]:
            chart_boxes = final_boxes[:, :self.chart_topk]
        decoded = self.roi_heads["decoder"](feats[:4])
        rois = roi_align(decoded, chart_boxes, self.chart_pooler_size, 0.25)
        k = rois.shape[1]
        head = self.roi_heads["densepose_head"](rois.reshape(b * k, *rois.shape[2:]))
        coarse, fine, u, v = self.roi_heads["densepose_predictor"](head)
        # ToChartResultConverter: the fine label where coarse says foreground;
        # U and V of that chart (a gather, equal to the JAX one-hot sum).
        fg = torch.argmax(coarse.float(), dim=1) > 0
        charts = torch.where(fg, torch.argmax(fine.float(), dim=1), 0)
        sel = charts[:, None]
        hm = charts.shape[-1]

        def chart_field(t):
            t = torch.clamp(t.float().gather(1, sel)[:, 0], 0.0, 1.0)
            return t.reshape(b, k, hm, hm)

        return {
            "boxes": final_boxes,
            "scores": torch.where(det_mask, final_scores, 0.0),
            "valid": det_mask,
            "charts": charts.to(torch.int32).reshape(b, k, hm, hm),
            "u": chart_field(u),
            "v": chart_field(v),
        }


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights: conv, deconv and linear kernels N(0, 1/fan_in)
    (fan_in over the input channels and the window), biases 0, BN identity,
    GroupNorm weight 1 and bias 0. Draws from ``generator`` in module order,
    on the CPU, so a seed gives the same weights everywhere."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                shape = m.weight.shape
                fan_in = (shape[0] * shape[2] * shape[3]
                          if isinstance(m, nn.ConvTranspose2d) else m.weight[0].numel())
                m.weight.copy_(torch.randn(shape, generator=generator) / fan_in ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
            elif isinstance(m, GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
    return model
