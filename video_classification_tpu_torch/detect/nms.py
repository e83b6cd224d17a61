"""Greedy non-maximum suppression: CUDA kernel K3 and its plain twin.

``nms`` replaces the JAX package's Pallas kernel
``detect/pallas_nms.py::_nms_kernel`` (entry ``nms_pallas``), whose results
equal the XLA ``detect/ops.py::nms``: ``max_out`` greedy iterations, each
taking the live box of the highest score (the first index on ties) and
suppressing it and every box whose IoU with it exceeds the threshold; a slot
whose best live score is not above NEG/2 is empty (index 0, mask False). See
``csrc/nms.cu`` for the design on Hopper.

``nms_reference`` is the same fixed-trip loop with plain tensor ops, batched
over frames, in the kernel's operation order: the CPU path and the kernel's
oracle on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils import cuda

NEG = -3.0e38  # the suppressed-score sentinel of the Pallas kernel


def nms(boxes: torch.Tensor, scores: torch.Tensor, max_out: int,
        iou_threshold: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N, 4) xyxy boxes, (B, N) scores -> (idx (B, max_out) int32,
    mask (B, max_out) bool), in keep (score-descending) order.

    CPU tensors run ``nms_reference``; CUDA tensors launch the kernel (and
    raise if it cannot build or launch), for any N. The kernel's route
    switches past N = 8192 (``route``): up to there a frame's boxes and sort
    keys, padded to a power of two, fill one block's shared memory
    (``nms_smem_bytes`` of csrc/nms.cu); past it the keys are sorted in
    device-memory scratch and the boxes read from device memory, with the
    same results."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or scores.shape != boxes.shape[:2]:
        raise ValueError(f"boxes must be (B, N, 4) and scores (B, N), got "
                         f"{tuple(boxes.shape)} and {tuple(scores.shape)}")
    if boxes.device.type == "cpu":
        return nms_reference(boxes, scores, max_out, iou_threshold)
    idx, mask = cuda.build().nms(boxes.float(), scores.float(), int(max_out),
                                 float(iou_threshold))
    nms.launches += 1
    return idx, mask


nms.launches = 0

MAX_SMEM = 232448  # dynamic shared memory of one H100 block (csrc/bindings.cpp)


def route(n: int) -> str:
    """'shared' or 'device': where K3 keeps a frame of ``n`` boxes' sort
    keys (csrc/nms.cu; 'shared' for n <= 8192)."""
    n_pad = max(64, 1 << (int(n) - 1).bit_length())
    return "shared" if 20 * int(n) + 8 * n_pad <= MAX_SMEM else "device"


def nms_reference(boxes: torch.Tensor, scores: torch.Tensor, max_out: int,
                  iou_threshold: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's greedy loop with plain tensor ops (any device)."""
    boxes = boxes.float()
    b, n = scores.shape
    dev = boxes.device
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0)
    live = scores.float().clone()
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
    half_neg = neg * 0.5
    thr = torch.tensor(iou_threshold, dtype=torch.float32, device=dev)
    lane = torch.arange(n, device=dev)
    idx = torch.zeros((b, max_out), dtype=torch.int32, device=dev)
    mask = torch.zeros((b, max_out), dtype=torch.bool, device=dev)
    for i in range(max_out):
        best = torch.argmax(live, dim=1, keepdim=True)          # first maximum
        valid = torch.gather(live, 1, best) > half_neg          # (B, 1)
        idx[:, i] = torch.where(valid, best, 0)[:, 0].to(torch.int32)
        mask[:, i] = valid[:, 0]

        def at(t):
            return torch.gather(t, 1, best)

        iw = torch.clamp(torch.minimum(x2, at(x2)) - torch.maximum(x1, at(x1)), min=0.0)
        ih = torch.clamp(torch.minimum(y2, at(y2)) - torch.maximum(y1, at(y1)), min=0.0)
        inter = iw * ih
        iou = inter / torch.clamp(area + at(area) - inter, min=1e-9)
        suppress = (iou > thr) | (lane == best)
        live = torch.where(valid & suppress, neg, live)
    return idx, mask
