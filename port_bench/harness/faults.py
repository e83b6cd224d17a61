"""Faults planted in the program under test, to show that the check catches
them (``port_bench/tests``, ``port_bench/calibrate.py``). Each takes what the
driver built (serving: the predictor and its streams; training: the
trainer) and breaks it in place; none is reachable from the command line.
"""

from __future__ import annotations

import numpy as np
import torch


def answer_altered(pred, streams) -> None:
    """Each stream's first clip's scores come out shifted by one class."""
    for p in streams.values():
        def scores(ds, _orig=p._scores):
            out = _orig(ds).copy()
            out[0] = np.roll(out[0], 1)
            return out
        p._scores = scores


def half_clips(pred, streams) -> None:
    """Only the first half of a request's clips is scored (at least one),
    and the video's mean taken over those."""
    for p in streams.values():
        def scores(ds, _orig=p._scores):
            out = _orig(ds)
            return out[:max(1, out.shape[0] // 2)]
        p._scores = scores


def flow_zero(pred, streams) -> None:
    """The flow stage returns the encoding of zero motion."""
    from video_classification_tpu_torch.pipeline import device_pipeline

    def zero_flow(frames, params=None):
        out = torch.zeros(frames.shape[:3] + (3,), dtype=torch.uint8, device=frames.device)
        out[..., :2] = 127
        return out

    device_pipeline.video_flow_uint8 = zero_flow


def _flow_params(change) -> None:
    from video_classification_tpu_torch.pipeline import device_pipeline

    flow = device_pipeline.video_flow_uint8

    def video_flow_uint8(frames, params=None):
        params = params if params is not None else device_pipeline.DEFAULT_PARAMS
        return flow(frames, params._replace(**change(params)))

    device_pipeline.video_flow_uint8 = video_flow_uint8


def flow_outers(pred, streams) -> None:
    """The flow relinearises each level half as often (7 outers: 3)."""
    _flow_params(lambda p: {"n_outer": max(1, p.n_outer // 2)})


def flow_sweeps(pred, streams) -> None:
    """The flow's SOR makes a third of its sweeps (30: 10)."""
    _flow_params(lambda p: {"n_sor": max(1, p.n_sor // 3)})


def half_batch(trainer) -> None:
    """Each step trains on the first half of its batch, the mean over it."""
    step = trainer.train_step

    def train_step(x, labels, *args, **kwargs):
        n = x.shape[0] // 2
        return step(x[:n], labels[:n])

    trainer.train_step = train_step


def unchanged(trainer) -> None:
    """The optimizer's step leaves the parameters as they were."""
    trainer.optimizer.step = lambda *a, **k: None


SERVE = {"answer_altered": answer_altered, "half_clips": half_clips, "flow_zero": flow_zero,
         "flow_outers": flow_outers, "flow_sweeps": flow_sweeps}
TRAIN = {"half_batch": half_batch, "unchanged": unchanged}
