"""Sparse ensemble fusion pipeline.

Port of the JAX package's ``engine/sparse.py`` (the reference's
train_sparse.py):

  * ``ResultSaver``: for each part stream, uniform-sampling loaders with no
    shuffle at batch BATCH_SIZE // 3 run through the stream's ``Trainer``
    (its best checkpoint), and ``{'ps', 't', 'acc', 'sv'}`` is pickled as
    plain numpy and Python values to ``<ROOT>/<LOGS>/sparse_fusion/{train,
    test}/<MODEL.NAME>`` (train_sparse.py:29-87), which either package reads.
  * ``SparseFusionDataset``: the part pickles stacked in sorted stem order
    into PS (P, N, C) (train_sparse.py:107-147).
  * ``SparseTrainer``: the per-class fusion (models/sparse_fusion.py)
    trained with Adam at 1e-3 (optax's defaults), batch 500, 2000 epochs,
    tested every 10 epochs on the per-video mean of the fused logits, and
    checkpointed on best accuracy (train_sparse.py:150-244). The scores live
    on the device for the whole run; an epoch is one pass over a shuffled
    permutation in which every sample is used exactly once (a short last
    batch, where the JAX package pads and masks: the loss is the same).
"""

from __future__ import annotations

import pickle
from functools import partial
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..config.defaults import load_model_cfg
from ..models.sparse_fusion import SparseModel
from ..ops.segment import per_video_accuracy, segment_ids_from_counts
from ..utils.cuda import resolve_device
from ..utils.logging import MetricsLogger

PART_YAMLS = [  # train_sparse.py:36
    "slowfast-HTAH",
    "slowfast-LHandArm",
    "slowfast-LHand",
    "slowfast-RHandArm",
    "slowfast-RHand",
]

SPARSE_BATCH = 500     # train_sparse.py:153
SPARSE_LR = 1e-3       # train_sparse.py:164
SPARSE_EPOCHS = 2000   # train_sparse.py:172
TEST_EVERY = 10        # train_sparse.py:190


def epoch_batch_plan(n: int, bs: int):
    """(num_batches, pad): ceil-divide n samples into bs-sized batches; the
    last batch is ``pad`` short of bs, so an epoch uses every sample once."""
    num_batches = max(1, -(-n // bs))
    return num_batches, num_batches * bs - n


def sparse_dir(cfg, name_of_set: str) -> Path:
    return Path(cfg.CHALEARN.ROOT, cfg.MODEL.LOGS, "sparse_fusion", name_of_set)


def fusion_ckpt_dir(cfg) -> Path:
    return Path(cfg.CHALEARN.ROOT, cfg.MODEL.LOGS, "sparse_fusion_ckpt")


class ResultSaver:
    """Dump per-part eval materials for fusion training. ``trainer_factory``
    (cfg -> Trainer) is injectable; by default the port's Trainer on
    ``device``."""

    def __init__(self, part_yamls: Optional[Sequence[str]] = None, cfg_overrides=None,
                 trainer_factory=None, device=None):
        self.part_yamls = list(part_yamls or PART_YAMLS)
        self.cfg_overrides = list(cfg_overrides or [])
        if trainer_factory is None:
            from .trainer import Trainer

            trainer_factory = partial(Trainer, device=device)
        self.trainer_factory = trainer_factory

    def load_part_cfgs(self):
        for name in self.part_yamls:
            yield load_model_cfg(name, overrides=self.cfg_overrides)

    def save_network_output(self) -> List[Path]:
        from ..data.dataset import ChalearnVideoDataset, eval_batches

        written = []
        for cfg in self.load_part_cfgs():
            trainer = self.trainer_factory(cfg)
            for name_of_set in ("train", "test"):
                # Uniform sampling, no shuffle, batch // 3 (train_sparse.py:56-64).
                ds = ChalearnVideoDataset(cfg, name_of_set, sampling="uniform")
                bs = max(1, int(cfg.CHALEARN.BATCH_SIZE) // 3)
                batches, sv = eval_batches(ds, bs)
                y = trainer.run_eval(batches=batches, samples_per_video=sv)
                y = {"ps": np.asarray(y["ps"], np.float32), "t": np.asarray(y["t"]),
                     "acc": float(y["acc"]), "sv": [int(s) for s in y["sv"]]}
                out = sparse_dir(cfg, name_of_set) / cfg.MODEL.NAME
                out.parent.mkdir(parents=True, exist_ok=True)
                with out.open("wb") as f:
                    pickle.dump(y, f)
                print(f"saved {out} (acc {y['acc']:.3f})")
                written.append(out)
            del trainer  # free this stream's model before the next one is built
        return written


class SparseFusionDataset:
    """Stack part pickles: PS (P, N, C), T (N,), sv (videos,). The pickles
    are unpickled, so they must come from ResultSaver (either package's)."""

    def __init__(self, res_folder: Path) -> None:
        part_res = []
        for p in sorted(Path(res_folder).iterdir()):
            with p.open("rb") as f:
                part_res.append((p.stem, pickle.load(f)))
        part_res.sort(key=lambda x: x[0])
        if not part_res:
            raise FileNotFoundError(f"no fusion materials in {res_folder}")
        self.part_names = [name for name, _ in part_res]
        t = np.stack([np.asarray(r["t"]) for _, r in part_res])
        if not (t == t[0]).all():
            raise ValueError("ground truth differs between parts")
        self.T = t[0].astype(np.int32)
        self.PS = np.stack([r["ps"] for _, r in part_res]).astype(np.float32)
        sv = [list(r["sv"]) for _, r in part_res]
        if any(s != sv[0] for s in sv):
            raise ValueError("clips per video differ between parts")
        self.sv = np.asarray(sv[0], np.int32)
        self.num_part, self.num_n, self.num_class = self.PS.shape

    def as_arrays(self):
        """x (N, P, C), the reference's batch layout, and T (N,)."""
        return np.transpose(self.PS, (1, 0, 2)), self.T


class SparseTrainer:
    """Trains the fusion on ``device`` (CUDA by default). The initial weight
    is drawn from a generator seeded by CUDA.SEED, and each epoch's
    permutation from a generator seeded by CUDA.SEED + 1, unless the caller
    passes the permutations (randomness cannot cross frameworks, so the
    tests pass the JAX package's)."""

    def __init__(self, cfg, batch_size: int = SPARSE_BATCH, device=None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.train_dataset = SparseFusionDataset(sparse_dir(cfg, "train"))
        self.test_dataset = SparseFusionDataset(sparse_dir(cfg, "test"))
        seed = int(cfg.CUDA.SEED)
        self.model = SparseModel(self.train_dataset.num_class, self.train_dataset.num_part,
                                 generator=torch.Generator().manual_seed(seed)).to(self.device)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=SPARSE_LR,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.generator = torch.Generator().manual_seed(seed + 1)
        self.max_accuracy = 0.0
        self.ckpt_folder = fusion_ckpt_dir(cfg)
        self.logger = MetricsLogger()
        x, t = self.train_dataset.as_arrays()
        self.x_train = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        self.t_train = torch.from_numpy(t.astype(np.int64)).to(self.device)
        x, t = self.test_dataset.as_arrays()
        self.x_test = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        self.t_test = torch.from_numpy(t.astype(np.int64)).to(self.device)
        sv = [int(s) for s in self.test_dataset.sv]
        self.test_segments = torch.from_numpy(
            segment_ids_from_counts(sv, len(t))).to(self.device)

    def train_epoch(self, perm=None) -> torch.Tensor:
        """One pass over a permutation of the training samples (drawn when
        not given), batch by batch, each sample once; returns the mean of
        the batches' losses as a device scalar (no synchronisation)."""
        n, bs = self.x_train.shape[0], self.batch_size
        if perm is None:
            perm = torch.randperm(n, generator=self.generator)
        perm = torch.as_tensor(perm, dtype=torch.int64).to(self.device)
        if perm.shape != (n,):
            raise ValueError(f"a permutation of {n} samples, got shape {tuple(perm.shape)}")
        num_batches, _ = epoch_batch_plan(n, bs)
        self.model.train()
        losses = []
        for i in range(num_batches):
            idx = perm[i * bs:(i + 1) * bs]
            loss = F.cross_entropy(self.model(self.x_train[idx]), self.t_train[idx])
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            self.optimizer.step()
            losses.append(loss.detach())
        return torch.stack(losses).mean()

    def train(self, epochs: int = SPARSE_EPOCHS, permutations=None) -> float:
        """``epochs`` epochs, testing every TEST_EVERY; ``permutations``
        (one per epoch) replace the drawn ones. Returns the best accuracy."""
        for epoch in range(epochs):
            self.train_epoch(None if permutations is None else permutations[epoch])
            if (epoch + 1) % TEST_EVERY == 0:
                self.test(epoch)
        return self.max_accuracy

    @torch.no_grad()
    def test(self, epoch: int = 0) -> float:
        """Video accuracy of the per-video mean of the fused logits;
        checkpoints a new best."""
        self.model.eval()
        logits = self.model(self.x_test)
        acc, _ = per_video_accuracy(logits, self.t_test, self.test_segments,
                                    len(self.test_dataset.sv))
        acc = float(acc)
        if acc > self.max_accuracy:
            self.save_ckpt(acc, epoch)
        self.max_accuracy = max(acc, self.max_accuracy)
        self.logger.log("sparse_test", epoch=epoch, acc=acc, best=self.max_accuracy)
        return acc

    def save_ckpt(self, acc: float, epoch: int) -> Path:
        """``sparse_fusion_ckpt/acc-%.3f-epoch-%d``: a torch.save of the
        state_dict ({'weight' (C, P), 'bias' (C,)}) on the CPU."""
        self.ckpt_folder.mkdir(parents=True, exist_ok=True)
        path = self.ckpt_folder / ("acc-%.3f-epoch-%d" % (acc, epoch))
        torch.save({k: v.detach().cpu() for k, v in self.model.state_dict().items()}, path)
        return path
