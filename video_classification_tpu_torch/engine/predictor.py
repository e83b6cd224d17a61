"""Serving path: raw gesture video -> class probabilities.

Port of the JAX package's ``engine/predictor.Predictor`` (one crop stream):
decode the raw M_/K_ video pair (or take decoded frames), run the device
preprocessing (pipeline/online.py) on every uniform clip window, score each
clip with the stream's SlowFast, and average the clip softmax scores (the
reference's eval aggregation, train.py:344-364). Clips stay on the device
from the raw frames to the scores. The five-stream ``EnsemblePredictor``
comes with the sparse-fusion slice.
"""

from __future__ import annotations

import random as pyrandom
from contextlib import nullcontext
from typing import Dict, Optional

import numpy as np
import torch

from ..pipeline.online import OnlineVideoDataset, flow_params_from_cfg, make_online_detector
from ..utils.cuda import resolve_device
from .checkpoint import load_checkpoint
from .model_manager import ModelManager


class Predictor:
    """Single crop-stream predictor over raw videos.

    ``device`` defaults to CUDA (raising if there is none); ``state_dict``
    skips the checkpoint lookup; ``timer`` (utils/profiling.StageTimer)
    records the 'detect', 'flow', 'crops' and 'network' stages."""

    def __init__(self, cfg, detector=None, flow_params=None, device=None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 timer=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mm = ModelManager(cfg, self.device)
        self.model = self.mm.init_model()
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        else:
            load_checkpoint(cfg, self.model)
        self._detector = detector
        self._flow_params = flow_params
        self.timer = timer

    def dataset(self, labels=None, videos=None) -> OnlineVideoDataset:
        """A fresh dataset per request: a caller holding an earlier result
        keeps reading its own video; the detector is shared."""
        if self._detector is None:
            self._detector = make_online_detector(self.cfg, self.device)
        fp = self._flow_params or flow_params_from_cfg(self.cfg)
        return OnlineVideoDataset(self.cfg, "test", detector=self._detector,
                                  flow_params=fp, labels=labels, videos=videos,
                                  device=self.device, timer=self.timer)

    @torch.inference_mode()
    def _scores(self, ds: OnlineVideoDataset) -> np.ndarray:
        clips = torch.stack(ds.get_eval_clips(0, pyrandom.Random(0))["clips"])
        bs = max(1, int(self.cfg.CHALEARN.BATCH_SIZE))
        outs = []
        stage = self.timer if self.timer is not None else (lambda _n: nullcontext())
        for start in range(0, clips.shape[0], bs):
            chunk = clips[start:start + bs]
            with stage("network"):
                logits = self.model(self.mm.normalize_and_prepare(chunk))
            outs.append(torch.softmax(logits.float(), dim=-1).cpu().numpy())
        return np.concatenate(outs, axis=0)

    def clip_scores(self, m_path, k_path=None) -> np.ndarray:
        """(n_clips, num_class) softmax scores of a video file pair."""
        return self._scores(self.dataset(labels=[(str(m_path), k_path and str(k_path), 1)]))

    def clip_scores_frames(self, rgb, depth=None) -> np.ndarray:
        """(n_clips, num_class) softmax scores of decoded frames: rgb
        (T, H, W, 3) uint8 BGR, depth (T, H, W, 1) uint8 or None (127 fill)."""
        return self._scores(self.dataset(videos={0: (rgb, depth)}))

    @staticmethod
    def _rank(ps: np.ndarray, top_k: int) -> Dict:
        probs = ps.mean(axis=0)
        order = np.argsort(-probs)[:top_k]
        return {"probs": probs, "clips": ps.shape[0],
                "top": [(int(i) + 1, float(probs[i])) for i in order]}

    def predict(self, m_path, k_path=None, top_k: int = 5) -> Dict:
        """Per-video prediction: {'probs': (C,), 'clips': n, 'top':
        [(label_1based, prob), ...]} from the mean clip score."""
        return self._rank(self.clip_scores(m_path, k_path), top_k)

    def predict_frames(self, rgb, depth=None, top_k: int = 5) -> Dict:
        return self._rank(self.clip_scores_frames(rgb, depth), top_k)
