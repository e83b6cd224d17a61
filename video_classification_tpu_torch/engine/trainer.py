"""Training and evaluation on one card.

Port of the JAX package's ``engine/trainer.py`` (the reference's ``Trainer``,
train.py:147-403):

  * the train step: normalize, RandomCrop at per-sample offsets, forward with
    train-mode BatchNorm and head dropout, weighted cross-entropy
    sum(ce * w) / max(sum(w), 1), backward, Adam at ``MODEL.LR`` with optax's
    defaults (betas 0.9 / 0.999, eps 1e-8 outside the square root);
  * ``train_epoch`` over shuffled batches made ahead by a producer thread
    (data/pipeline.prefetch_to_device), with the metrics fetched once per
    epoch; ``train`` with best-accuracy checkpoints and a final save;
  * ``run_eval``: softmax scores of every uniformly sampled clip, averaged
    per video (train.py:287-370), returning {'ps', 't', 'acc', 'sv'}.

DEBUG mirrors the reference's knobs (train.py:150-158, 244-245, 257-260,
329-330): one train batch per epoch, at most 3 epochs, eval capped at 6
batches, no checkpoint or metrics file written.

Randomness comes from explicit generators seeded by ``CUDA.SEED``: a
``random.Random(seed + epoch)`` per epoch shuffles and samples clips, as in
the JAX package, and one ``torch.Generator`` on the device draws the crop
offsets and the dropout masks. On one card no batch is padded, so every row
has weight 1.
"""

from __future__ import annotations

import itertools
from functools import partial
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..data.dataset import ChalearnVideoDataset, eval_batches, train_batches
from ..data.pipeline import prefetch_to_device
from ..ops.segment import per_video_accuracy, segment_ids_from_counts
from ..utils.cuda import resolve_device
from ..utils.logging import MetricsLogger
from .checkpoint import load_checkpoint, save_checkpoint
from .model_manager import ModelManager

DEBUG_MAX_EPOCH = 3       # train.py:257-260
DEBUG_EVAL_BATCHES = 6    # train.py:329-330


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           weights: torch.Tensor) -> Dict[str, torch.Tensor]:
    """{'loss': sum(ce * w) / max(sum(w), 1), 'correct': sum((argmax ==
    label) * w), 'count': sum(w)}, the cross-entropy in float32. Rows of
    weight 0 add nothing."""
    ce = F.cross_entropy(logits.float(), labels, reduction="none")
    count = weights.sum()
    loss = (ce * weights).sum() / torch.clamp(count, min=1.0)
    correct = ((torch.argmax(logits, dim=-1) == labels) * weights).sum()
    return {"loss": loss, "correct": correct, "count": count}


class Trainer:
    """``dataset_factory(cfg, name_of_set)`` and ``model_manager`` are
    injectable; by default ``DATA.BACKEND online`` reads raw videos through
    the device preprocessing (pipeline/online.OnlineVideoDataset) and any
    other backend the crop-stream folders (data/dataset.ChalearnVideoDataset).
    ``device`` defaults to CUDA and raises without a card."""

    def __init__(self, cfg, torch_warmstart: Optional[Path] = None,
                 dataset_factory=None, model_manager=None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.debug = bool(cfg.DEBUG)
        self.batch_size = int(cfg.CHALEARN.BATCH_SIZE)
        if dataset_factory is not None:
            make_ds = dataset_factory
        elif str(cfg.DATA.BACKEND) == "online":
            from ..pipeline.online import OnlineVideoDataset

            make_ds = partial(OnlineVideoDataset, device=self.device)
        else:
            make_ds = ChalearnVideoDataset
        self.train_dataset = make_ds(cfg, "train")
        self.test_dataset = make_ds(cfg, "test")

        self.mm = model_manager if model_manager is not None else ModelManager(cfg, self.device)
        self.model = self.mm.init_model()
        load_checkpoint(cfg, self.model, torch_warmstart)
        self.logger = MetricsLogger() if self.debug else MetricsLogger.for_model(cfg)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=float(cfg.MODEL.LR),
                                          betas=(0.9, 0.999), eps=1e-8)
        self.generator = torch.Generator(self.device).manual_seed(int(cfg.CUDA.SEED))
        self.max_historical_acc = 0.0

    # -- training ----------------------------------------------------------------

    def train_step(self, x: torch.Tensor, labels: torch.Tensor,
                   weights: Optional[torch.Tensor] = None,
                   offsets: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One optimizer step on a (N, T, H, W, 21) uint8 batch on the device.
        ``weights`` (N,) default to 1; ``offsets`` (N, 2) are the crop
        windows, drawn from the trainer's generator when not given. Returns
        device scalars {'loss', 'correct', 'count'} (no synchronisation); the
        parameters' ``.grad`` hold this step's gradients until the next."""
        rf = torch.profiler.record_function  # phases of profile_train
        labels = labels.to(self.device, torch.int64)
        if weights is None:
            weights = torch.ones(labels.shape, dtype=torch.float32, device=self.device)
        if offsets is None:
            offsets = self.mm.crop_offsets(x, self.generator)
        self.model.train()
        with rf("train::glue"):
            inputs = self.mm.normalize_and_prepare(x, offsets)
        with rf("train::forward"):
            m = weighted_cross_entropy(self.model(inputs, generator=self.generator),
                                       labels, weights)
        with rf("train::backward"):
            self.optimizer.zero_grad(set_to_none=True)
            m["loss"].backward()
        with rf("train::adam"):
            self.optimizer.step()
        return {k: v.detach() for k, v in m.items()}

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        batches = train_batches(self.train_dataset, self.batch_size,
                                seed=int(self.cfg.CUDA.SEED) + epoch)
        if self.debug:
            batches = itertools.islice(batches, 1)
        pending = []  # device scalars, fetched once per epoch
        for batch in prefetch_to_device(batches, self.device,
                                        int(self.cfg.CUDA.PREFETCH_DEPTH)):
            m = self.train_step(batch["x"], batch["label"])
            pending.append(torch.stack([m["loss"], m["correct"], m["count"]]))
        metrics = torch.stack(pending).tolist() if pending else []
        losses = [m[0] for m in metrics]
        correct = int(sum(m[1] for m in metrics))
        count = int(sum(m[2] for m in metrics))
        loss_avg = float(np.mean(losses)) if losses else float("nan")
        acc = correct / max(count, 1)
        self.logger.log("train_epoch", epoch=epoch, loss=loss_avg, acc=acc,
                        correct=correct, count=count)
        return {"loss": loss_avg, "acc": acc}

    def train(self) -> float:
        max_epoch = DEBUG_MAX_EPOCH if self.debug else int(self.cfg.MODEL.MAX_EPOCH)
        acc = 0.0
        epoch = 0
        for epoch in range(max_epoch):
            self.train_epoch(epoch)
            acc = float(self.run_eval()["acc"])
            if acc > self.max_historical_acc:
                self.max_historical_acc = acc
                self._save(epoch, acc)
            else:
                self.logger.log("ckpt_skipped", best=self.max_historical_acc)
        self._save(epoch, acc)  # final save (train.py:284)
        return self.max_historical_acc

    def _save(self, epoch: int, acc: float) -> None:
        path = save_checkpoint(self.cfg, self.model, epoch, acc)
        if path is not None:
            self.logger.log("ckpt_saved", path=str(path), acc=acc, epoch=epoch)

    # -- evaluation --------------------------------------------------------------

    @torch.inference_mode()
    def eval_scores(self, x) -> torch.Tensor:
        """(N, num_class) float32 softmax scores of a uint8 clip batch."""
        self.model.eval()
        x = torch.as_tensor(x).to(self.device)
        return torch.softmax(self.model(self.mm.normalize_and_prepare(x)).float(), dim=-1)

    def run_eval(self, dataset=None, batches: Optional[Iterator] = None,
                 samples_per_video: Optional[List[int]] = None) -> Dict:
        """Uniform-sampled, per-video mean-score eval (train.py:287-370).

        Returns {'ps': (N_clips, C) softmax scores, 't': (N_clips,) labels,
        'acc': video accuracy, 'sv': clips per video}; in DEBUG the batches
        stop after 6 and 'sv' keeps the videos whose clips were all scored."""
        if batches is None:
            ds = dataset if dataset is not None else self.test_dataset
            batches, samples_per_video = eval_batches(ds, self.batch_size)
        it = itertools.islice(batches, DEBUG_EVAL_BATCHES) if self.debug else batches
        pending = [(self.eval_scores(b["x"]), b["valid"], b["label"]) for b in it]
        ps = np.concatenate([s.cpu().numpy()[np.asarray(v)] for s, v, _ in pending])
        t = np.concatenate([np.asarray(l)[np.asarray(v)] for _, v, l in pending])
        total = ps.shape[0]
        clipped_sv: List[int] = []
        acc_total = 0
        for n in samples_per_video:
            if acc_total + n > total:
                break
            clipped_sv.append(n)
            acc_total += n
        ps_used, t_used = ps[:acc_total], t[:acc_total]
        seg = segment_ids_from_counts(clipped_sv, acc_total)
        acc, _ = per_video_accuracy(torch.from_numpy(ps_used), torch.from_numpy(t_used),
                                    torch.from_numpy(seg), len(clipped_sv))
        acc = float(acc)
        self.logger.log("eval", acc=acc, videos=len(clipped_sv), clips=acc_total)
        return {"ps": ps_used, "t": t_used, "acc": acc, "sv": clipped_sv}


def train_unimportant_parts(cfg_base=None, device=None) -> Dict[str, float]:
    """Train the 8 disabled crop streams (train.py:385-403)."""
    from ..config import get_cfg
    from ..config.crop_cfg import extra_crop_folder_list

    results = {}
    for crop_name in extra_crop_folder_list:
        cfg = cfg_base.clone() if cfg_base is not None else get_cfg()
        cfg.CHALEARN.BATCH_SIZE = 80
        cfg.MODEL.NAME = "slowfast-" + crop_name
        cfg.MODEL.R3D_INPUT = crop_name
        cfg.MODEL.LR = 2e-4
        cfg.MODEL.MAX_EPOCH = 50
        results[crop_name] = Trainer(cfg, device=device).train()
    return results
