"""The PyTorch port's train loop on its own (CPU, depth 18, CLIP_LEN 4,
CropLHand, 3 classes, batch 4, synthetic data): the DEBUG knobs (one train
batch per epoch, three epochs, eval capped at six batches, nothing
written), a loss that falls over epochs, best-accuracy and final checkpoints
restored through tiers 1 and 2, and ``Trainer(cfg)`` raising without a
card. The step itself is held against the JAX package in
test_torch_port_trainer.py.
"""

import numpy as np
import pytest
import torch

from video_classification_tpu_torch.engine import Trainer, ckpt_dir, load_checkpoint
from test_torch_port_trainer import _port_cfg
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)


def test_debug_knobs(tmp_path):
    cfg = _port_cfg(tmp_path, debug=True)
    pt = Trainer(cfg, device="cpu")
    steps = []
    orig = pt.train_step
    pt.train_step = lambda *a, **k: steps.append(1) or orig(*a, **k)
    assert pt.train() == pt.max_historical_acc
    assert len(steps) == 3  # one batch per epoch, three epochs
    assert not (tmp_path / "logs").exists()  # no checkpoint, no metrics file
    pt.batch_size = 1
    y = pt.run_eval()  # 8 one-clip videos, eval capped at 6 batches
    assert y["sv"] == [1] * 6 and y["ps"].shape == (6, 3) and y["t"].shape == (6,)


def test_loss_falls_and_checkpoints_restore(tmp_path):
    cfg = _port_cfg(tmp_path)
    pt = Trainer(cfg, device="cpu")
    first = pt.train_epoch(0)
    for epoch in range(1, 5):
        last = pt.train_epoch(epoch)
    assert np.isfinite(last["loss"]) and last["loss"] < first["loss"]
    best = pt.train()  # MAX_EPOCH 1: one epoch, a best save and the final save
    files = sorted(ckpt_dir(cfg).glob("*.ckpt"))
    assert files and pt.max_historical_acc == best
    fresh = Trainer(cfg, device="cpu")  # tier 1
    for k, v in pt.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    part = cfg.clone()
    part.MODEL.NAME = "slowfast-HTAH"
    for f in files:
        (ckpt_dir(part)).mkdir(parents=True, exist_ok=True)
        (ckpt_dir(part) / f.name).write_bytes(f.read_bytes())
    part.MODEL.NAME = "slowfast-LHand"
    assert load_checkpoint(part, fresh.model) == ckpt_dir(cfg).parent / "slowfast-HTAH" / files[-1].name


def test_trainer_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(_port_cfg(tmp_path))
