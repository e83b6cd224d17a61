"""Training and evaluation on one card, or data-parallel over ranks.

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

Data parallelism (the JAX package's multi-process path): when a
``torch.distributed`` process group exists (parallel/multihost.
initialize_distributed), each rank is one replica and the step is the JAX
package's global-view step on the global batch ``CHALEARN.BATCH_SIZE``,
which must divide by the world size:

  * rank p trains on the contiguous rows p of each global batch
    (data/dataset.train_batches_for_host), every row of weight 1;
  * BatchNorm's training moments are those of the global batch
    (models/layers.set_batchnorm_group), the biased variance as on one card;
  * each rank's loss is sum(ce * w) over its rows / max(sum(w) over the
    global batch, 1), so the gradients summed over the ranks (one
    all-reduce) are the global loss's, even when ranks hold different
    sum(w); the reported loss, 'correct' and 'count' are the global ones;
  * the crop offsets and the dropout mask are drawn for the whole global
    batch, from a generator in the same state on every rank, and each rank
    keeps its rows: the draws of the one-process step;
  * eval decodes each rank's share of the videos (``sharded_eval_plan``)
    and gathers the scores back into the one-process clip order;
  * only rank 0 writes checkpoints and the metrics file.
The same code runs a world of one rank.
"""

from __future__ import annotations

import itertools
from functools import partial
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..data.dataset import (ChalearnVideoDataset, eval_batches, train_batches,
                            train_batches_for_host)
from ..data.pipeline import prefetch_to_device
from ..models.layers import set_batchnorm_group
from ..ops.segment import per_video_accuracy, segment_ids_from_counts
from ..parallel import multihost
from ..parallel.mesh import pad_batch_for_mesh
from ..utils.cuda import resolve_device
from ..utils.logging import MetricsLogger
from .checkpoint import load_checkpoint, save_checkpoint
from .model_manager import ModelManager

DEBUG_MAX_EPOCH = 3       # train.py:257-260
DEBUG_EVAL_BATCHES = 6    # train.py:329-330


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           weights: torch.Tensor,
                           total_weight: Optional[torch.Tensor] = None
                           ) -> Dict[str, torch.Tensor]:
    """{'loss': sum(ce * w) / max(W, 1), 'correct': sum((argmax == label) *
    w), 'count': sum(w)}, the cross-entropy in float32, where W is
    ``total_weight`` (a rank's share of the global batch's loss takes the
    global sum(w)) or sum(w). Rows of weight 0 add nothing."""
    ce = F.cross_entropy(logits.float(), labels, reduction="none")
    count = weights.sum()
    denom = count if total_weight is None else total_weight
    loss = (ce * weights).sum() / torch.clamp(denom, min=1.0)
    correct = ((torch.argmax(logits, dim=-1) == labels) * weights).sum()
    return {"loss": loss, "correct": correct, "count": count}


class Trainer:
    """``dataset_factory(cfg, name_of_set)`` and ``model_manager`` are
    injectable; by default ``DATA.BACKEND online`` reads raw videos through
    the device preprocessing (pipeline/online.OnlineVideoDataset) and any
    other backend the crop-stream folders (data/dataset.ChalearnVideoDataset).
    ``device`` defaults to CUDA and raises without a card. ``distributed``
    (default: whether a process group exists) makes this trainer one
    data-parallel replica of the default group's world; False trains alone
    (train_streams_parallel's streams in threads)."""

    def __init__(self, cfg, torch_warmstart: Optional[Path] = None,
                 dataset_factory=None, model_manager=None, device=None,
                 distributed: Optional[bool] = None):
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

        # Data parallelism: a process group makes this rank one replica.
        if distributed is None:
            distributed = dist.is_available() and dist.is_initialized()
        self.group = dist.group.WORLD if distributed else None
        self.n_processes = multihost.process_count() if distributed else 1
        self.process_index = multihost.process_index() if distributed else 0
        if self.batch_size % self.n_processes:
            raise ValueError(
                f"data-parallel training requires CHALEARN.BATCH_SIZE ({self.batch_size}) "
                f"divisible by the world size ({self.n_processes}) so every rank feeds "
                "equal shards")

        self.mm = model_manager if model_manager is not None else ModelManager(cfg, self.device)
        self.model = self.mm.init_model()
        load_checkpoint(cfg, self.model, torch_warmstart)
        if self.group is not None:
            set_batchnorm_group(self.model, self.group)
            for t in self.model.state_dict().values():  # every replica starts as rank 0
                dist.broadcast(t, 0, group=self.group)
        self.logger = (MetricsLogger() if self.debug or self.process_index != 0
                       else MetricsLogger.for_model(cfg))
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=float(cfg.MODEL.LR),
                                          betas=(0.9, 0.999), eps=1e-8)
        self.generator = torch.Generator(self.device).manual_seed(int(cfg.CUDA.SEED))
        self.max_historical_acc = 0.0
        for m in self.model.modules():  # dropout masks drawn for the global batch
            if hasattr(m, "dropout_shard"):
                m.dropout_shard = (self.process_index, self.n_processes)

    # -- training ----------------------------------------------------------------

    def train_step(self, x: torch.Tensor, labels: torch.Tensor,
                   weights: Optional[torch.Tensor] = None,
                   offsets: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One optimizer step on a (N, T, H, W, 21) uint8 batch on the device
        (data-parallel: this rank's N rows of the global batch). ``weights``
        (N,) default to 1; ``offsets`` (N, 2) are the crop windows of these
        rows, drawn from the trainer's generator (for the global batch) when
        not given. Returns device scalars {'loss', 'correct', 'count'} of the
        global batch (no synchronisation); the parameters' ``.grad`` hold
        this step's gradients until the next."""
        rf = torch.profiler.record_function  # phases of profile_train
        labels = labels.to(self.device, torch.int64)
        if weights is None:
            weights = torch.ones(labels.shape, dtype=torch.float32, device=self.device)
        weights = weights.to(self.device, torch.float32)
        if offsets is None:
            n, rank = x.shape[0], self.process_index
            offsets = self.mm.crop_offsets(x, self.generator, rows=n * self.n_processes)
            offsets = offsets[rank * n:(rank + 1) * n]
        self.model.train()
        total_weight = None
        if self.group is not None:
            total_weight = weights.sum().detach().clone()
            dist.all_reduce(total_weight, group=self.group)
        with rf("train::glue"):
            inputs = self.mm.normalize_and_prepare(x, offsets)
        with rf("train::forward"):
            m = weighted_cross_entropy(self.model(inputs, generator=self.generator),
                                       labels, weights, total_weight)
        with rf("train::backward"):
            self.optimizer.zero_grad(set_to_none=True)
            m["loss"].backward()
        out = {k: v.detach() for k, v in m.items()}
        if self.group is not None:
            out = self._all_reduce_gradients(out)
        with rf("train::adam"):
            self.optimizer.step()
        return out

    def _all_reduce_gradients(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Sums every gradient, the loss and 'correct' over the ranks, in one
        all-reduce of one flat buffer; 'count' becomes the global sum(w)."""
        params = [p for p in self.model.parameters() if p.grad is not None]
        flat = torch.cat([p.grad.reshape(-1).float() for p in params]
                         + [metrics["loss"].reshape(1).float(),
                            metrics["correct"].reshape(1).float(),
                            metrics["count"].reshape(1).float()])
        dist.all_reduce(flat, group=self.group)
        at = 0
        for p in params:
            p.grad.copy_(flat[at:at + p.numel()].view_as(p.grad))
            at += p.numel()
        return {"loss": flat[at], "correct": flat[at + 1], "count": flat[at + 2]}

    def _pad_for_mesh(self, batch: Dict) -> Dict:
        """The batch padded to a multiple of the world size (copies of row
        0, parallel/mesh.pad_batch_for_mesh), with 'weight' (1 for a real
        row, 0 for padding) and 'valid' (a real row that is valid); one
        process pads nothing."""
        n = batch["x"].shape[0]
        padded, n_real = pad_batch_for_mesh(batch, self.n_processes)
        total = padded["x"].shape[0]
        padded = dict(padded, weight=np.zeros((total,), np.float32),
                      valid=np.zeros((total,), bool))
        padded["weight"][:n_real] = 1.0
        padded["valid"][:n_real] = np.asarray(batch.get("valid", np.ones(n, bool)))
        return padded

    def _host_local_weight(self, batch: Dict) -> Dict:
        """A rank's train rows are always real (host_batch_indices tiles the
        remainder up to a full batch): 'weight' and 'valid' all ones."""
        n = batch["x"].shape[0]
        return dict(batch, weight=np.ones((n,), np.float32), valid=np.ones((n,), bool))

    def _train_batches(self, epoch: int):
        seed = int(self.cfg.CUDA.SEED) + epoch
        if self.group is None:
            return map(self._pad_for_mesh,
                       train_batches(self.train_dataset, self.batch_size, seed=seed))
        return map(self._host_local_weight,
                   train_batches_for_host(self.train_dataset, self.batch_size, seed=seed,
                                          n_processes=self.n_processes,
                                          index=self.process_index))

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        batches = self._train_batches(epoch)
        if self.debug:
            batches = itertools.islice(batches, 1)
        pending = []  # device scalars, fetched once per epoch
        for batch in prefetch_to_device(batches, self.device,
                                        int(self.cfg.CUDA.PREFETCH_DEPTH)):
            m = self.train_step(batch["x"], batch["label"], batch["weight"])
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
        if self.process_index != 0:  # one writer; the replicas are equal
            return
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
            if self.group is not None:
                return self._run_eval_sharded(ds)
            batches, samples_per_video = eval_batches(ds, self.batch_size)
        it = itertools.islice(batches, DEBUG_EVAL_BATCHES) if self.debug else batches
        pending = [(self.eval_scores(b["x"]), b["valid"], b["label"])
                   for b in map(self._pad_for_mesh, it)]
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

    def _run_eval_sharded(self, ds) -> Dict:
        """Data-parallel eval with sharded decode: rank q decodes only
        videos q, q+P, ... (data/dataset.eval_batches_for_host) and scores
        its rows; one all-gather brings every rank's scores, which go back
        into the global video-major clip order: the clips, labels and
        accuracy of the one-process eval, each rank decoding N/P videos."""
        from ..data.dataset import eval_batches_for_host, sharded_eval_plan

        plan = sharded_eval_plan(ds, self.batch_size, self.n_processes)
        gen = eval_batches_for_host(ds, plan, self.process_index, seed=int(self.cfg.CUDA.SEED))
        n_steps = min(plan.n_steps, DEBUG_EVAL_BATCHES) if self.debug else plan.n_steps
        local = torch.stack([self.eval_scores(next(gen)["x"]) for _ in range(n_steps)])
        fetched = multihost.all_gather_rows(local[None], self.group).cpu().numpy()
        total = int(sum(plan.samples_per_video))
        ps = np.zeros((total, fetched.shape[-1]), np.float32)
        scored = np.zeros(total, bool)
        lb = plan.local_batch
        for q in range(plan.n_processes):
            for s in range(n_steps):
                pos = plan.positions[q][s * lb:(s + 1) * lb]
                ps[pos] = fetched[q, s, :len(pos)]
                scored[pos] = True
        # The leading run of videos whose every clip was scored (DEBUG's
        # step cap may cut; a full run keeps everything).
        clipped_sv: List[int] = []
        acc_total = 0
        for n in plan.samples_per_video:
            if not scored[acc_total:acc_total + n].all():
                break
            clipped_sv.append(n)
            acc_total += n
        ps_used, t_used = ps[:acc_total], plan.labels[:acc_total]
        seg = segment_ids_from_counts(clipped_sv, acc_total)
        acc, _ = per_video_accuracy(torch.from_numpy(ps_used), torch.from_numpy(t_used),
                                    torch.from_numpy(seg), len(clipped_sv))
        acc = float(acc)
        self.logger.log("eval", acc=acc, videos=len(clipped_sv), clips=acc_total,
                        sharded_decode=True)
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
