"""The PyTorch port's ``Trainer`` against the JAX package's (CPU, float32).

Depth 18, CLIP_LEN 4, CropLHand, 3 classes, batch 4, on the synthetic
dataset; both trainers get the same numpy-seeded weights (carried by
``models/convert.state_dict_from_jax``). The JAX trainer runs on a
one-device mesh, so no mesh-padding row enters its BatchNorm statistics;
both models' head dropout is 0 (JAX: ``model.clone(dropout_rate=0.0)``), and
the crop offsets the JAX step draws from its key are derived here exactly as
``random_crop_batch_mxu`` derives them and passed to the port's step. The
JAX trainer's optimizer is ``optax.chain(record, adam)``, where ``record``
only keeps the gradients in its state, so one compiled JAX step gives both
the gradients and the updated state.

  * ``run_eval`` on the same weights: 't' and 'sv' equal, 'ps' within
    5e-3, 'acc' equal;
  * one train step: loss within 1e-5 relative. The gradients are held
    against the JAX package's own float32 resolution, measured here: the
    same JAX gradient with the batch rows permuted (mathematically equal,
    summed in another order) moves by a relative L2 of ~1.2e-2 over all
    tensors and up to ~2.5e-2 for one tensor, so a flat 1e-3 per tensor is
    finer than either framework resolves for this network in float32.
    Bars: over all tensors the port is no farther from the JAX gradient
    than that spread (nor than 1e-3, if larger); each tensor within twice
    the largest per-tensor spread (or 1e-3) and at a cosine >= 0.999; the
    new running statistics within atol = rtol = 5e-3;
    the parameters after the step within atol = rtol = 5e-3 wherever
    |g| > 1e-6 (Adam's first step is about lr * sign(g), so near-zero
    gradients may move either way; Adam itself is held on injected
    gradients in test_torch_port_train_ops.py);
  * tier 3: the same synthesized pytorchvideo-grammar pickle through both
    ``load_torch_warmstart``: every kept key equal, the mismatched keys left
    at their initial values.

The port's train loop on its own is tested in test_torch_port_trainer_loop.py.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from video_classification_tpu.config import get_cfg as jax_get_cfg
from video_classification_tpu.data.dataset import train_batches as jax_train_batches
from video_classification_tpu.engine import Trainer as JaxTrainer
from video_classification_tpu.engine.checkpoint import load_torch_warmstart as jax_warmstart
from video_classification_tpu.engine.trainer import TrainState
from video_classification_tpu.models.torch_convert import MISMATCH_LAYERS, flax_to_torch
from video_classification_tpu.parallel import make_mesh
from video_classification_tpu_torch.config import get_cfg
from video_classification_tpu_torch.engine import Trainer, load_checkpoint, load_torch_warmstart
from video_classification_tpu_torch.engine.checkpoint import MISMATCH_LAYERS as PORT_MISMATCH
from video_classification_tpu_torch.models import state_dict_from_jax
from test_torch_port_train_ops import jax_crop_offsets
from torch_port_support import one_torch_thread, randomised_variables  # noqa: F401

BATCH = 4


def _configure(c, root):
    c.CHALEARN.ROOT = str(root)
    c.CHALEARN.NUM_CLASS = 3
    c.CHALEARN.CLIP_LEN = 4
    c.CHALEARN.BATCH_SIZE = BATCH
    c.MODEL.NAME = "slowfast-port-train"
    c.MODEL.R3D_INPUT = "CropLHand"
    c.MODEL.DEPTH = 18
    c.MODEL.MAX_EPOCH = 1
    c.DATA.SYNTHETIC_NUM_VIDEOS = 8
    c.DATA.SYNTHETIC_SEQ_LEN = 6
    return c


def _port_cfg(root, debug=False):
    cfg = _configure(get_cfg(), root)
    cfg.CUDA.COMPUTE_DTYPE = "float32"
    cfg.DEBUG = debug
    return cfg


def _record_grads():
    """An optax transformation that passes updates through and keeps them
    (the gradients, first in a chain) as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _np(t):
    return t.detach().cpu().numpy()


def _jax_grads(model, variables, inputs, labels):
    """The JAX train step's gradient (mean cross-entropy, batch statistics
    of the batch) of given pathway inputs, [slow, fast] NTHWC."""

    @jax.jit
    def grads(params, xs, y):
        def loss_fn(p):
            logits, _ = model.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                    xs, train=True, mutable=["batch_stats"])
            return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(logits, y))
        return jax.grad(loss_fn)(params)

    return grads(variables["params"], inputs, labels)


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer_parity")
    jcfg = _configure(jax_get_cfg(), root / "jax")
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    jcfg.TPU.DONATE_STATE = False
    jt = JaxTrainer(jcfg, mesh=make_mesh(jcfg, devices=jax.devices()[:1]))
    variables = randomised_variables(
        {"params": jt.state.params, "batch_stats": jt.state.batch_stats}, seed=3)
    tx = optax.chain(_record_grads(), optax.adam(float(jcfg.MODEL.LR)))
    jt.model = jt.model.clone(dropout_rate=0.0)
    jt.state = TrainState.create(apply_fn=jt.model.apply, params=variables["params"],
                                 batch_stats=variables["batch_stats"], tx=tx)
    jt._train_step = jt._build_train_step()

    pt = Trainer(_port_cfg(root / "port"), device="cpu")
    pt.model.load_state_dict(state_dict_from_jax(variables))
    pt.model.blocks[6].dropout_rate = 0.0

    out = {"variables": variables, "jax_eval": jt.run_eval(), "port_eval": pt.run_eval()}
    batch = next(jax_train_batches(jt.train_dataset, BATCH, seed=0))
    step_rng = jax.random.PRNGKey(11)
    size = pt.mm.crop_size
    offsets = jax_crop_offsets(jax.random.split(step_rng)[0], BATCH, size, size, size,
                               size // 10)
    state, metrics = jt._train_step(jt.state, batch["x"], batch["label"],
                                    np.ones(BATCH, np.float32), step_rng)
    out["jax_loss"] = float(metrics["loss"])
    out["jax_grads"] = state_dict_from_jax({"params": jax.device_get(state.opt_state[0])})
    out["jax_after"] = state_dict_from_jax(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats}))
    # JAX's own float32 spread: the same gradient with the batch rows permuted.
    inputs = [_np(t.permute(0, 2, 3, 4, 1)) for t in pt.mm.normalize_and_prepare(
        torch.from_numpy(batch["x"]), torch.from_numpy(offsets))]
    perm = np.asarray([2, 0, 3, 1])
    spread = [state_dict_from_jax({"params": jax.device_get(_jax_grads(
        jt.model, variables, [x[rows] for x in inputs], batch["label"][rows]))})
        for rows in (np.arange(BATCH), perm)]
    out["jax_spread"] = spread
    m = pt.train_step(torch.from_numpy(batch["x"]), torch.from_numpy(batch["label"]),
                      offsets=torch.from_numpy(offsets))
    out["port_loss"] = float(m["loss"])
    out["port_grads"] = {k: p.grad.clone() for k, p in pt.model.named_parameters()}
    out["port_after"] = {k: v.clone() for k, v in pt.model.state_dict().items()}
    return out


def test_run_eval_matches_jax(parity):
    j, p = parity["jax_eval"], parity["port_eval"]
    assert set(p) == {"ps", "t", "acc", "sv"}
    assert p["sv"] == j["sv"] and len(p["sv"]) == 8
    np.testing.assert_array_equal(p["t"], j["t"])
    np.testing.assert_allclose(p["ps"], j["ps"], atol=5e-3, rtol=5e-3)
    assert p["acc"] == j["acc"]


def test_train_step_loss_and_gradients_match_jax(parity):
    np.testing.assert_allclose(parity["port_loss"], parity["jax_loss"], rtol=1e-5)
    jg, pg, (s0, s1) = parity["jax_grads"], parity["port_grads"], parity["jax_spread"]
    assert set(jg) == set(pg) == set(s0)

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    def flat(d):
        return np.concatenate([np.asarray(d[k]).ravel() for k in sorted(jg)])

    port = {k: _np(g) for k, g in pg.items()}
    want = {k: v.numpy() for k, v in jg.items()}
    spread_all = rel(flat(s1), flat(s0))
    spread_max = max(rel(s1[k].numpy(), s0[k].numpy()) for k in s0)
    assert rel(flat(port), flat(want)) <= max(1e-3, spread_all), spread_all
    for k in port:
        err = rel(port[k], want[k])
        cos = float(np.dot(port[k].ravel(), want[k].ravel())
                    / (np.linalg.norm(port[k]) * np.linalg.norm(want[k])))
        assert err <= max(1e-3, 2 * spread_max) and cos >= 0.999, (k, err, cos, spread_max)


def test_train_step_state_matches_jax(parity):
    after, want, grads = parity["port_after"], parity["jax_after"], parity["jax_grads"]
    assert set(after) == set(want)
    for k, v in after.items():
        if "running_" in k:
            np.testing.assert_allclose(_np(v), want[k].numpy(), atol=5e-3, rtol=5e-3,
                                       err_msg=k)
        else:
            moved = np.abs(grads[k].numpy()) > 1e-6
            np.testing.assert_allclose(_np(v)[moved], want[k].numpy()[moved],
                                       atol=5e-3, rtol=5e-3, err_msg=k)
    # The step did move the parameters and the statistics.
    before = state_dict_from_jax(parity["variables"])
    assert any(not torch.equal(before[k], after[k]) for k in after if "running_" in k)


def test_tier3_warmstart_matches_jax(parity, tmp_path):
    assert PORT_MISMATCH == MISMATCH_LAYERS
    variables = randomised_variables(parity["variables"], seed=9)
    sd = flax_to_torch(variables)
    kinetics_shapes = {"blocks.6.proj.weight": (400, sd["blocks.6.proj.weight"].shape[1]),
                       "blocks.6.proj.bias": (400,)}
    for k in MISMATCH_LAYERS:  # other input channels / classes in Kinetics
        if k in sd:
            shape = kinetics_shapes.get(k, (sd[k].shape[0], 3) + sd[k].shape[2:])
            sd[k] = np.ones(shape, np.float32)
    sd["blocks.0.multipathway_blocks.0.norm.num_batches_tracked"] = np.asarray(7)
    sd["blocks.9.unknown.weight"] = np.zeros(3, np.float32)
    path = tmp_path / "kinetics.pyth"
    path.write_bytes(pickle.dumps({"model_state": sd}))

    template = jax.device_get({"params": parity["variables"]["params"],
                               "batch_stats": parity["variables"]["batch_stats"]})
    want = state_dict_from_jax(jax_warmstart(path, template))
    pt = Trainer(_port_cfg(tmp_path / "root", debug=True), device="cpu")
    init = {k: v.clone() for k, v in pt.model.state_dict().items()}
    assert load_checkpoint(pt.cfg, pt.model, torch_warmstart=path) == path
    got = pt.model.state_dict()
    mismatched = set(MISMATCH_LAYERS) & set(got)
    assert mismatched and set(got) == set(want)
    for k, v in got.items():
        if k in mismatched:
            assert torch.equal(v, init[k]), k
        else:
            assert torch.equal(v, want[k]), k
    # A raw state_dict pickle is read too.
    path.write_bytes(pickle.dumps({k: v for k, v in sd.items()}))
    kept = load_torch_warmstart(path, pt.model)
    assert set(kept) == set(got) - mismatched
