"""Remat (``CUDA.REMAT``, ``CUDA.REMAT_POLICY``) in the port's SlowFast
against the JAX package's ``TPU.REMAT`` (CPU, float32).

SlowFast at depth 18, narrow (stem widths (16, 2), 3 classes), train mode,
head dropout 0, on a numpy-seeded (2, T 4, 32x32) batch; both models get the
same numpy-seeded weights (``models/convert.state_dict_from_jax``). One
train step (mean cross-entropy, batch statistics, backward):

  * the port with remat at "" and at "conv" against JAX with remat at the
    same policy: logits and loss within 5e-3; gradients at the train
    slice's bars (test_torch_port_trainer.py: over all tensors no farther
    from JAX than JAX's own float32 spread, the gradient with the batch
    rows permuted, nor than 1e-3; each tensor within twice the largest
    per-tensor spread or 1e-3, cosine >= 0.999); running statistics within
    5e-3;
  * the port with remat against the port without it: logits, loss,
    gradients and running statistics bit-equal (a recomputed stage
    performs the same float operations on the CPU, and updates no running
    statistic: only the first forward does);
  * the stages are checkpointed (the recomputation runs in the backward),
    and "conv" keeps the convolutions: it recomputes fewer operations than
    "" does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from video_classification_tpu.config import get_cfg as jax_get_cfg
from video_classification_tpu.models.slowfast import init_my_slowfast as jax_slowfast
from video_classification_tpu_torch.config import get_cfg
from video_classification_tpu_torch.models import state_dict_from_jax
from video_classification_tpu_torch.models.slowfast import init_my_slowfast
from torch_port_support import one_torch_thread, randomised_variables  # noqa: F401

STEMS = (16, 2)
SHAPE = (2, 4, 32, 32)  # N, T, H, W
LABELS = np.asarray([2, 0], np.int32)


def _cfgs(remat, policy=""):
    jcfg, cfg = jax_get_cfg(), get_cfg()
    for c in (jcfg, cfg):
        c.CHALEARN.NUM_CLASS = 3
        c.MODEL.DEPTH = 18
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    jcfg.TPU.REMAT, jcfg.TPU.REMAT_POLICY = remat, policy
    cfg.CUDA.COMPUTE_DTYPE = "float32"
    cfg.CUDA.REMAT, cfg.CUDA.REMAT_POLICY = remat, policy
    return jcfg, cfg


def _inputs():
    rng = np.random.RandomState(0)
    n, t, h, w = SHAPE
    return [rng.normal(0, 1, (n, t, h, w, c)).astype(np.float32) for c in (5, 15)]


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs(False)
    model = jax_slowfast(jcfg, stem_dim_outs=STEMS).clone(dropout_rate=0.0)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               [jnp.asarray(x) for x in _inputs()]))
    return randomised_variables(shapes, seed=5)


def _jax_step(policy, variables, rows=None):
    jcfg, _ = _cfgs(True, policy)
    model = jax_slowfast(jcfg, stem_dim_outs=STEMS).clone(dropout_rate=0.0)
    xs, labels = _inputs(), LABELS
    if rows is not None:
        xs, labels = [x[rows] for x in xs], labels[rows]

    @jax.jit
    def step(params, xs, y):
        def loss_fn(p):
            logits, new = model.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                      xs, train=True, mutable=["batch_stats"])
            ce = optax.softmax_cross_entropy_with_integer_labels(logits, y)
            return jnp.mean(ce), (logits, new["batch_stats"])
        (loss, (logits, stats)), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return loss, logits, g, stats

    loss, logits, g, stats = jax.device_get(step(variables["params"], xs, labels))
    return {"loss": float(loss), "logits": np.asarray(logits),
            "grads": {k: v.numpy() for k, v in state_dict_from_jax({"params": g}).items()},
            "stats": {k: v.numpy() for k, v in state_dict_from_jax(
                {"batch_stats": stats}).items()}}


def _port_step(variables, remat, policy=""):
    _, cfg = _cfgs(remat, policy)
    model = init_my_slowfast(cfg, stem_dim_outs=STEMS)
    model.load_state_dict(state_dict_from_jax(variables))
    model.blocks[6].dropout_rate = 0.0
    model.train()
    xs = [torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous() for x in _inputs()]
    logits = model(xs)
    loss = F.cross_entropy(logits, torch.from_numpy(LABELS).long())
    loss.backward()
    sd = model.state_dict()
    return {"loss": float(loss.detach()), "logits": logits.detach().numpy(),
            "grads": {k: p.grad.numpy().copy() for k, p in model.named_parameters()},
            "stats": {k: v.numpy().copy() for k, v in sd.items() if "running_" in k},
            "model": model}


@pytest.fixture(scope="module")
def steps(weights):
    out = {"plain": _port_step(weights, False)}
    for policy in ("", "conv"):
        out[f"port {policy}"] = _port_step(weights, True, policy)
        out[f"jax {policy}"] = _jax_step(policy, weights)
    out["jax spread"] = _jax_step("", weights, rows=np.asarray([1, 0]))
    return out


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("policy", ["", "conv"])
def test_remat_matches_jax_remat(steps, policy):
    port, jx = steps[f"port {policy}"], steps[f"jax {policy}"]
    np.testing.assert_allclose(port["logits"], jx["logits"], atol=5e-3, rtol=5e-3)
    np.testing.assert_allclose(port["loss"], jx["loss"], atol=5e-3, rtol=5e-3)
    keys = sorted(jx["grads"])
    assert set(port["grads"]) == set(keys)
    s0, s1 = steps["jax "]["grads"], steps["jax spread"]["grads"]

    def flat(d):
        return np.concatenate([d[k].ravel() for k in keys])

    spread_all = _rel(flat(s1), flat(s0))
    spread_max = max(_rel(s1[k], s0[k]) for k in keys)
    assert _rel(flat(port["grads"]), flat(jx["grads"])) <= max(1e-3, spread_all)
    for k in keys:
        a, b = port["grads"][k], jx["grads"][k]
        cos = float(np.dot(a.ravel(), b.ravel()) / (np.linalg.norm(a) * np.linalg.norm(b)))
        assert _rel(a, b) <= max(1e-3, 2 * spread_max) and cos >= 0.999, (k, spread_max)
    assert set(port["stats"]) == set(jx["stats"])
    for k, v in port["stats"].items():
        np.testing.assert_allclose(v, jx["stats"][k], atol=5e-3, rtol=5e-3, err_msg=k)


@pytest.mark.parametrize("policy", ["", "conv"])
def test_remat_is_bit_equal_to_no_remat(steps, policy):
    port, plain = steps[f"port {policy}"], steps["plain"]
    assert np.array_equal(port["logits"], plain["logits"]) and port["loss"] == plain["loss"]
    for k, g in plain["grads"].items():
        assert np.array_equal(port["grads"][k], g), k
    for k, v in plain["stats"].items():  # one momentum update, not two
        assert np.array_equal(port["stats"][k], v), k
    assert any(not np.array_equal(v, 0.0 if "mean" in k else 1.0)
               for k, v in plain["stats"].items())


def _recomputed_convolutions(weights, policy):
    """Convolutions run in the backward (recomputation) of one step."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func == torch.ops.aten.convolution.default:
                self.n += 1
            return func(*args, **(kwargs or {}))

    _, cfg = _cfgs(policy is not None, policy or "")
    model = init_my_slowfast(cfg, stem_dim_outs=STEMS)
    model.load_state_dict(state_dict_from_jax(weights))
    model.blocks[6].dropout_rate = 0.0
    model.train()
    xs = [torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous() for x in _inputs()]
    loss = model(xs).sum()
    with Count() as count:
        loss.backward()
    return count.n


def test_stages_are_recomputed_in_the_backward(weights):
    n = {p: _recomputed_convolutions(weights, p) for p in (None, "", "conv")}
    assert n[None] == 0 and n["conv"] == 0
    # depth 18: one block of four convolutions (three + the projection) per
    # stage, two pathways, four stages.
    assert n[""] == 4 * 2 * 4, n


def test_unknown_policy_raises():
    _, cfg = _cfgs(True, "dots")
    with pytest.raises(ValueError, match="remat_policy"):
        init_my_slowfast(cfg)
