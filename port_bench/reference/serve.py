"""The reference's answer to a served video: per-clip class probabilities.

A served video is cut as the ChaLearn reference's eval cuts it
(chalearn_dataset.py:123-140): one frame in ``interval`` is sampled, the
sampled frames form CLIP_LEN windows at a stride of 4 (a video of at most
CLIP_LEN sampled frames gives one window that wraps around), and each
window carries the raw frames its flow needs: sampled frame k at position
(k + 1) * interval, preceded by its interval - 1 flow companions, plus one
leading frame, indices clamped at the start of the video. Every window's
clip is its flow images (each the flow of the pair of raw frames at
positions j - 1, j; the flow of a pair is solved once per video, however
many windows share it), its part crops (``reference.crops``) and the
network's softmax (``reference.slowfast``). ``fuse`` is the per-class
sparse fusion of the ensemble (train_sparse.py).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import crops, flow
from .slowfast import SlowFast, pathways

UNIFORM_STRIDE = 4


def window_indices(n_raw: int, clip_len: int, interval: int) -> List[np.ndarray]:
    """The raw-frame indices of each eval window of an ``n_raw``-frame video."""
    seq = max(-(-n_raw // interval), 1)
    if seq <= clip_len:
        sampled = [[i % seq for i in range(clip_len)]]
    else:
        sampled = [list(range(t, t + clip_len))
                   for t in range(0, seq - clip_len, UNIFORM_STRIDE)]
    windows = []
    for idx in sampled:
        n = clip_len * interval + 1
        raw = np.zeros((n,), np.int64)
        raw[0] = idx[0] * interval - interval
        for j in range(1, n):
            k = (j - 1) // interval
            raw[j] = idx[k] * interval - ((k + 1) * interval - j)
        windows.append(np.clip(raw, 0, n_raw - 1))
    return windows


def video_clips(rgb: torch.Tensor, depth: torch.Tensor, folders: Sequence[str],
                clip_len: int = 20, interval: int = 5,
                params: flow.FlowParams = flow.FlowParams(), spent=None,
                window_flows: Optional[List[torch.Tensor]] = None,
                quant=flow.F32) -> Dict[str, torch.Tensor]:
    """{folder: (n_clips, CLIP_LEN, size, size, 21) uint8} of one video
    (rgb (T, H, W, 3), depth (T, H, W, 1) uint8 on the device). ``spent``, a
    dict, gains the seconds of the flow ('flow') and of the crops ('crops').
    ``window_flows``, a list, gains each window's flow images at its
    positions 1 .. CLIP_LEN x interval ((CLIP_LEN x interval, H, W, 3)
    uint8: position j's is the flow of the window's raw frames j - 1, j).
    ``quant`` rounds what the flow solver keeps (``flow.pair_flows``)."""
    windows = window_indices(rgb.shape[0], clip_len, interval)
    pairs = sorted({(int(w[j - 1]), int(w[j])) for w in windows for j in range(1, len(w))})
    t0 = time.perf_counter()
    images = flow.pair_flows(rgb, torch.tensor(pairs), params, quant=quant)
    if spent is not None:
        images.cpu()
        t1 = time.perf_counter()
        spent["flow"] = spent.get("flow", 0.0) + t1 - t0
    where = {pr: i for i, pr in enumerate(pairs)}
    out: Dict[str, list] = {f: [] for f in folders}
    for w in windows:
        rows = [0] + [where[(int(w[j - 1]), int(w[j]))] for j in range(1, len(w))]
        idx = torch.from_numpy(w).to(rgb.device)
        made = crops.window_crops(rgb[idx], depth[idx], images[torch.tensor(rows)],
                                  folders, interval)
        if window_flows is not None:
            window_flows.append(images[torch.tensor(rows[1:])])
        for f in folders:
            out[f].append(made[f])
    clips = {f: torch.stack(v) for f, v in out.items()}
    if spent is not None:
        clips[folders[0]].cpu()
        spent["crops"] = spent.get("crops", 0.0) + time.perf_counter() - t1
    return clips


@torch.no_grad()
def clip_probs(model: SlowFast, clips: torch.Tensor, batch: int = 8) -> torch.Tensor:
    """(n, classes) float32 softmax of (n, T, S, S, 21) uint8 clips, the
    model in eval mode."""
    model.eval()
    out = [torch.softmax(model(pathways(clips[i:i + batch])), dim=-1)
           for i in range(0, clips.shape[0], batch)]
    return torch.cat(out)


def fuse(per_stream: Sequence[torch.Tensor], weight: torch.Tensor,
         bias: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(classes,) probabilities of the five streams' (n, classes) clip
    scores, in the streams' sorted-name order: per clip and class
    sum_p w[c, p] x[p, c] + b[c] (computed in ``dtype``), then the softmax of
    the mean over clips."""
    n = min(p.shape[0] for p in per_stream)
    x = torch.stack([p[:n] for p in per_stream], dim=1).to(dtype)   # (n, P, C)
    logits = (x * weight.t().to(dtype)[None]).sum(dim=1) + bias.to(dtype)
    return torch.softmax(logits.float().mean(dim=0), dim=-1)
