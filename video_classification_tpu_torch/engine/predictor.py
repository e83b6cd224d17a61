"""Serving path: raw gesture video -> class probabilities.

Port of the JAX package's ``engine/predictor.py``:

  * ``Predictor`` (one crop stream): decode the raw M_/K_ video pair (or
    take decoded frames), run the device preprocessing (pipeline/online.py)
    on every uniform clip window, score each clip with the stream's network,
    and average the clip softmax scores (the reference's eval aggregation,
    train.py:344-364). Clips stay on the device from the raw frames to the
    scores.
  * ``EnsemblePredictor``: the full system, the five part streams of
    train_sparse.py:36 fused by the per-class SparseModel restored from the
    sparse-fusion checkpoint.
"""

from __future__ import annotations

import random as pyrandom
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config.defaults import load_model_cfg
from ..models.sparse_fusion import SparseModel
from ..pipeline.online import OnlineVideoDataset, flow_params_from_cfg, make_online_detector
from ..utils.cuda import resolve_device
from ..utils.profiling import span, stage
from .checkpoint import load_checkpoint, read_state_dict
from .model_manager import ModelManager
from .sparse import PART_YAMLS, fusion_ckpt_dir


class Predictor:
    """Single crop-stream predictor over raw videos.

    ``device`` defaults to CUDA (raising if there is none); ``state_dict``
    skips the checkpoint lookup; ``timer`` (utils/profiling.StageTimer)
    records the 'detect', 'flow', 'crops' and 'network' stages. ``requests``
    counts the requests served, the ordinal their ``serve::request`` spans
    carry."""

    requests = 0

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
        for start in range(0, clips.shape[0], bs):
            chunk = clips[start:start + bs]
            with stage(self.timer, "network"):
                logits = self.model(self.mm.normalize_and_prepare(chunk))
            outs.append(torch.softmax(logits.float(), dim=-1).cpu().numpy())
        return np.concatenate(outs, axis=0)

    def clip_scores(self, m_path, k_path=None) -> np.ndarray:
        """(n_clips, num_class) softmax scores of a video file pair."""
        with span("serve::stream", str(self.cfg.MODEL.NAME)):
            return self._scores(self.dataset(labels=[(str(m_path), k_path and str(k_path), 1)]))

    def clip_scores_frames(self, rgb, depth=None) -> np.ndarray:
        """(n_clips, num_class) softmax scores of decoded frames: rgb
        (T, H, W, 3) uint8 BGR, depth (T, H, W, 1) uint8 or None (127 fill)."""
        with span("serve::stream", str(self.cfg.MODEL.NAME)):
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
        self.requests += 1
        with span("serve::request", str(self.requests)):
            return self._rank(self.clip_scores(m_path, k_path), top_k)

    def predict_frames(self, rgb, depth=None, top_k: int = 5) -> Dict:
        self.requests += 1
        with span("serve::request", str(self.requests)):
            return self._rank(self.clip_scores_frames(rgb, depth), top_k)


class EnsemblePredictor:
    """The reference's full system: the part streams of ``part_yamls``
    (default ``engine/sparse.PART_YAMLS``), one ``Predictor`` each with its
    own per-request dataset, all given the same ``detector`` and
    ``flow_params``, fused per class. ``fusion_params`` ({'weight' (C, P),
    'bias' (C,)}) skips the checkpoint lookup; otherwise the
    lexicographically last file of ``sparse_fusion_ckpt/`` is loaded, the
    port's ``torch.save`` or the JAX package's flax msgpack file, and with
    none the weight and bias are all ones (uniform mixing). ``requests``
    counts the requests served, as ``Predictor.requests`` does."""

    requests = 0

    def __init__(self, part_yamls: Optional[Sequence[str]] = None,
                 cfg_overrides: Optional[List[str]] = None,
                 detector=None, flow_params=None, fusion_params=None, device=None):
        self.device = resolve_device(device)
        self.part_yamls = list(part_yamls or PART_YAMLS)
        overrides = list(cfg_overrides or [])
        self.predictors = [
            Predictor(load_model_cfg(name, overrides=overrides), detector=detector,
                      flow_params=flow_params, device=self.device)
            for name in self.part_yamls]
        self.cfg = self.predictors[0].cfg
        self._fusion_params = fusion_params
        self.fusion: Optional[SparseModel] = None
        self.fusion_source: Optional[str] = None

    def _load_fusion(self, num_part: int, num_class: int) -> None:
        model = SparseModel(num_class, num_part)
        if self._fusion_params is not None:
            state, self.fusion_source = self._fusion_params, "given"
        else:
            d = fusion_ckpt_dir(self.cfg)
            ckpts = sorted(d.iterdir()) if d.is_dir() else []
            if ckpts:
                print(f"loading fusion checkpoint {ckpts[-1]}")
                state = read_state_dict(ckpts[-1])
                self.fusion_source = str(ckpts[-1])
            else:
                print("warning: no sparse-fusion checkpoint; using uniform mixing")
                state = {k: torch.ones_like(v) for k, v in model.state_dict().items()}
                self.fusion_source = "uniform"
        model.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in state.items()})
        self.fusion = model.to(self.device).eval()

    @torch.inference_mode()
    def _fuse(self, named_scores, top_k: int) -> Dict:
        # Part order must match SparseFusionDataset's sorted stacking: the
        # streams are sorted by name before fusing.
        with span("stage::fuse"):
            n = min(ps.shape[0] for _, ps in named_scores)
            x = np.stack([ps[:n] for _, ps in named_scores], axis=1)  # (n, P, C)
            if self.fusion is None:
                self._load_fusion(x.shape[1], x.shape[2])
            logits = self.fusion(torch.from_numpy(x).to(self.device))
            # Softmax after the mean of the fused logits over the clips.
            probs = torch.softmax(logits.mean(dim=0), dim=-1).cpu().numpy()
        order = np.argsort(-probs)[:top_k]
        return {
            "probs": probs,
            "clips": n,
            "per_stream": {name: float(ps[:n].mean(0).max()) for name, ps in named_scores},
            "top": [(int(i) + 1, float(probs[i])) for i in order],
        }

    def _streams(self):
        return sorted(zip(self.part_yamls, self.predictors), key=lambda x: x[0])

    def predict(self, m_path, k_path=None, top_k: int = 5) -> Dict:
        """{'probs': (C,), 'clips': n, 'per_stream': {name: top mean score},
        'top': [(label_1based, prob), ...]} of a video file pair; n is the
        fewest clips of any stream."""
        self.requests += 1
        with span("serve::request", str(self.requests)):
            return self._fuse([(name, p.clip_scores(m_path, k_path))
                               for name, p in self._streams()], top_k)

    def predict_frames(self, rgb, depth=None, top_k: int = 5) -> Dict:
        """``predict`` of decoded frames: rgb (T, H, W, 3) uint8 BGR, depth
        (T, H, W, 1) uint8 or None."""
        self.requests += 1
        with span("serve::request", str(self.requests)):
            return self._fuse([(name, p.clip_scores_frames(rgb, depth))
                               for name, p in self._streams()], top_k)
