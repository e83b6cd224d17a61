"""Data-parallel training and sharded eval of the port's ``Trainer`` on two
gloo ranks (CPU, two processes, each with a timeout and a free port), against
the one-process ``Trainer`` on the same global batches.

The tiny synthetic slowfast config of ``torch_port_ranks.tiny_cfg`` (depth
18, float32, global batch 4, head dropout 0.5 on): the synthetic clips do
not depend on the clip sampler, so the one-process ``train_batches`` and the
ranks' ``train_batches_for_host`` give the same global batches, and the crop
offsets and dropout masks the ranks draw for the global batch are the
one-process step's. Checked:

  * both ranks report the same epoch loss, bit-equal, and hold bit-equal
    parameters and BatchNorm statistics after two steps;
  * these match the one-process steps: the first step's loss (the same
    parameters on both sides) within 1e-5 relative; the parameters and
    running statistics after two steps within atol = rtol = 5e-3 (the
    train slice's bars). The second step's loss is held within 1e-3
    relative, with its cause stated: Adam's first update moves every
    parameter by about lr * sign(g), so a gradient component near zero
    whose float32 sum rounds to the other sign over two ranks than over one
    batch moves by 2 lr = 1e-3; measured here 1.7e-4 relative on the
    second loss, 2.3e-7 on the first;
  * the sharded eval on the initial weights gives the one-process clip
    order ('sv'), labels and accuracy exactly, and scores within 5e-3;
  * only rank 0 writes checkpoints;
  * the gradient is the global loss's when the ranks hold different
    sum(w) (a weighted step, one process per rank emulated in-process by
    the same arithmetic as ``weighted_cross_entropy``).
"""

import numpy as np
import pytest
import torch

from video_classification_tpu_torch.engine.model_manager import ModelManager
from video_classification_tpu_torch.engine.trainer import weighted_cross_entropy
from torch_port_ranks import run_ranks, tiny_cfg, trainer_run
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp")
    results = run_ranks(["tests/torch_port_ranks.py", "trainer", str(out)])
    for rc, stdout, err in results:
        assert rc == 0, err[-3000:]
        assert "backend gloo" in stdout
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]
    single = trainer_run(tiny_cfg(out / "single"))
    init = ModelManager(tiny_cfg(out / "init"), torch.device("cpu")).init_model().state_dict()
    return {"ranks": ranks, "single": single, "init": init, "out": out}


def test_ranks_are_bit_equal(runs):
    a, b = runs["ranks"]
    assert a["n_processes"] == b["n_processes"] == 2
    assert a["epoch"] == b["epoch"] and a["losses"] == b["losses"]
    assert set(a["state"]) == set(b["state"])
    for k, v in a["state"].items():
        assert torch.equal(v, b["state"][k]), k
    assert a["best"] == b["best"]


def test_ranks_match_the_one_process_step(runs):
    rank, single = runs["ranks"][0], runs["single"]
    assert single["n_processes"] == 1
    assert len(rank["losses"]) == len(single["losses"]) == 4  # two epochs of two steps
    np.testing.assert_allclose(rank["losses"][0], single["losses"][0], rtol=1e-5)
    np.testing.assert_allclose(rank["losses"][1], single["losses"][1], rtol=1e-3)
    np.testing.assert_allclose(rank["epoch"]["loss"], np.mean(rank["losses"][:2]), rtol=1e-6)
    assert rank["epoch"]["acc"] == single["epoch"]["acc"]
    moved = 0
    for k, v in single["state"].items():
        np.testing.assert_allclose(rank["state"][k].numpy(), v.numpy(), atol=5e-3, rtol=5e-3,
                                   err_msg=k)
        moved += int(not torch.equal(v, runs["init"][k]))
    assert moved > 10  # the step moved the parameters and statistics


def test_sharded_eval_equals_the_one_process_eval(runs):
    single = runs["single"]["eval"]
    for rank in runs["ranks"]:
        got = rank["eval"]
        assert got["sv"] == single["sv"] and len(got["sv"]) == 8
        assert sum(got["sv"]) > 8  # several clips a video
        np.testing.assert_array_equal(got["t"], single["t"])
        np.testing.assert_allclose(got["ps"], single["ps"], atol=5e-3, rtol=5e-3)
        assert got["acc"] == single["acc"]


def test_only_rank_0_writes_checkpoints(runs):
    out = runs["out"]
    written = [sorted(p.name for p in (out / f"rank{r}").rglob("*.ckpt")) for r in range(2)]
    single = sorted(p.name for p in (out / "single").rglob("*.ckpt"))
    assert written[0] == single and len(single) >= 1
    assert written[1] == []


@pytest.mark.parametrize("weights", [[1, 1, 1, 1], [1, 0, 1, 1], [0, 0, 1, 0]])
def test_rank_losses_sum_to_the_global_gradient(weights):
    """Two ranks' losses, each over its rows but divided by the global
    sum(w), summed (as the all-reduce of their gradients sums them), give
    the global loss's gradient, also when the ranks' sum(w) differ."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(4, 5, generator=g, requires_grad=True)
    labels = torch.tensor([0, 3, 2, 4])
    w = torch.tensor(weights, dtype=torch.float32)
    whole = weighted_cross_entropy(logits, labels, w)
    (want,) = torch.autograd.grad(whole["loss"], logits)
    parts = [weighted_cross_entropy(logits[i:i + 2], labels[i:i + 2], w[i:i + 2], w.sum())
             for i in (0, 2)]
    (got,) = torch.autograd.grad(parts[0]["loss"] + parts[1]["loss"], logits)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(parts[0]["loss"] + parts[1]["loss"], whole["loss"])


def test_pad_for_mesh_and_host_local_weight(tmp_path):
    """The JAX Trainer's ``_pad_for_mesh`` (engine/trainer.py:181-196) and
    ``_host_local_weight`` (:200-207): padding copies row 0 up to a multiple
    of the world size, 'weight' marks the real rows, 'valid' the real rows
    that were valid; a rank's train rows are all real."""
    from video_classification_tpu_torch.engine import Trainer

    t = Trainer(tiny_cfg(tmp_path), device="cpu")
    batch = {"x": np.arange(3)[:, None] + np.zeros((3, 2)), "label": np.array([4, 5, 6]),
             "valid": np.array([True, False, True])}
    assert t.n_processes == 1
    same = t._pad_for_mesh(batch)
    np.testing.assert_array_equal(same["x"], batch["x"])
    assert same["weight"].tolist() == [1, 1, 1] and same["valid"].tolist() == [1, 0, 1]
    t.n_processes = 2  # as a rank of a world of two pads
    padded = t._pad_for_mesh(batch)
    assert padded["x"][:, 0].tolist() == [0, 1, 2, 0] and padded["label"].tolist() == [4, 5, 6, 4]
    assert padded["weight"].tolist() == [1, 1, 1, 0]
    assert padded["valid"].tolist() == [True, False, True, False]
    local = t._host_local_weight({"x": batch["x"], "label": batch["label"]})
    assert local["weight"].tolist() == [1, 1, 1] and local["valid"].all()
