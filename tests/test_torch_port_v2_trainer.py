"""The port's ``V2Trainer`` (``v2/trainer.py``) against the JAX package's
(CPU, float32 and float64).

  * SGD: ``torch.optim.SGD(lr, momentum=0.9)`` (dampening 0, no Nesterov)
    against ``optax.sgd(lr, momentum=0.9)`` on injected gradients, over
    three steps;
  * ``V2ModelManager``: the pathway split [0:5] / [5:7], x * (1/255) in
    float32, and the crop at the JAX key's offsets equal the JAX manager's
    ``normalize_and_prepare``;
  * one ``V2Trainer`` step and ``run_eval`` against the JAX ``V2Trainer``
    on the same v2 folders (four 10-frame 48x64 videos per set, written by
    the port's converters through cv2), depth 18, INPUT_SIZE 64, CLIP_LEN 4,
    batch 4: a one-device mesh, numpy-seeded weights carried by
    ``models/convert.state_dict_from_jax``, head dropout 0, the crop
    offsets the JAX step draws from its key passed to the port's step. The
    JAX optimizer is ``optax.chain(record, sgd)`` (``record`` keeps the
    gradients). The JAX trainer's own initialisation is only traced, as its
    weights are replaced. The eval is held at test_torch_port_trainer.py's bars
    (scores within 5e-3; labels, clips per video and accuracy equal).

The step is taken four times: by each package in float32 and in float64.
The JAX steps run under ``jax.enable_x64`` (so the key draws int64 crop
offsets, the same for both of them, and the port is given those). JAX's
``BatchNormLean`` names float32 for its statistics, so for its float64 step
``layers.py`` reads ``jnp.float32`` as float64; nothing else of it changes.

  * float64, a bar independent of float32 resolution: the port's loss, its
    gradients (over all tensors and per tensor) and what the step moved
    (each parameter and running statistic, after minus before) within 1e-6
    relative of the JAX float64 step's (measured: gradients 6.0e-8 over all
    and 1.1e-7 for the worst tensor; the port takes its cross-entropy in
    float32);
  * float32, at bars read from the JAX package alone: the port may sit
    from the JAX float32 gradient twice as far as that gradient sits from
    the JAX float64 one (or 1e-3, if larger), over all tensors and per
    tensor, and so for each tensor's cosine (1 - cos); the loss likewise
    (or 1e-5 relative); the running statistics and parameters after the
    step within atol = rtol = 5e-3.

Measured here: the JAX float32 gradient is 5.9e-2 from the float64 one over
all tensors (0.17 for the worst tensor, the lowest cosine 0.987), the
port's float32 gradient 2.5e-3 (5.0e-3, 0.99999); the float32 losses
2.0e-4 and 3.4e-7 relative. The gap is JAX's float32 batch statistics: a
JAX float64 step that keeps ``BatchNormLean``'s float32 statistics sits
5.3e-2 from the float64 gradient. Those statistics are E[x^2] - E[x]^2
reduced in float32, which cancels where the mean is large against the
spread (v2 feeds x/255 with no mean removed; its flow channels sit near
0.5), and XLA's CPU reduction loses more of it than torch's, which sums the
same formula in a finer order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from video_classification_tpu.config import get_cfg as jax_get_cfg
from video_classification_tpu.data.dataset import train_batches as jax_train_batches
from video_classification_tpu.engine.trainer import Trainer as JaxTrainer, TrainState
from video_classification_tpu.models import layers as jax_layers
from video_classification_tpu.parallel import make_mesh
from video_classification_tpu.v2 import V2Trainer as JaxV2Trainer
from video_classification_tpu.v2.trainer import V2ModelManager as JaxV2ModelManager
from video_classification_tpu_torch.config import get_cfg
from video_classification_tpu_torch.data.fixture import generate_raw_fixture
from video_classification_tpu_torch.models import state_dict_from_jax
from video_classification_tpu_torch.ops.flow import FlowParams
from video_classification_tpu_torch.pipeline import stages
from video_classification_tpu_torch.pipeline.frame_io import Cv2FrameIO
from video_classification_tpu_torch.pipeline.iuv_contract import SyntheticIUVProvider
from video_classification_tpu_torch.profile_v2 import run_v2_convert
from video_classification_tpu_torch.v2 import V2ModelManager, V2Trainer
from test_torch_port_train_ops import jax_crop_offsets
from test_torch_port_trainer import _np, _record_grads
from torch_port_support import one_torch_thread, randomised_variables  # noqa: F401

BATCH = 4
SETS = ("train", "test")


def _configure(c, root):
    c.CHALEARN.ROOT = str(root)
    c.CHALEARN.NUM_CLASS = 3
    c.CHALEARN.SAMPLE_CLASS = 3
    c.CHALEARN.CLIP_LEN = 4
    c.CHALEARN.BATCH_SIZE = BATCH
    c.MODEL.NAME = "slowfast-port-v2"
    c.MODEL.INPUT_SIZE = 64
    c.MODEL.DEPTH = 18
    c.MODEL.MAX_EPOCH = 1
    return c


def test_sgd_matches_optax_on_injected_gradients():
    rng = np.random.RandomState(8)
    lr = 2e-4
    shapes = {"a": (7, 3), "b": (11,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = torch.optim.SGD(tp.values(), lr=lr, momentum=0.9, dampening=0.0, nesterov=False)
    tx = optax.sgd(lr, momentum=0.9)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    for _ in range(3):
        g = {k: (rng.normal(size=s) * 10.0 ** rng.randint(-6, 2, s)).astype(np.float32)
             for k, s in shapes.items()}
        for k in shapes:
            tp[k].grad = torch.from_numpy(g[k])
        opt.step()
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       atol=1e-7, rtol=1e-6)


def test_model_manager_matches_jax():
    cfg = _configure(get_cfg(), "/nonexistent")
    cfg.CUDA.COMPUTE_DTYPE = "float32"
    jcfg = _configure(jax_get_cfg(), "/nonexistent")
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    x = np.random.RandomState(2).randint(0, 256, (3, 4, 64, 64, 7)).astype(np.uint8)
    key = jax.random.PRNGKey(4)
    offsets = jax_crop_offsets(key, 3, 64, 64, 64, 6)
    want = JaxV2ModelManager(jcfg).normalize_and_prepare(jnp.asarray(x), augment_rng=key)
    mm = V2ModelManager(cfg, device="cpu")
    got = mm.normalize_and_prepare(torch.from_numpy(x), torch.from_numpy(offsets))
    assert [tuple(t.shape) for t in got] == [(3, 5, 4, 64, 64), (3, 2, 4, 64, 64)]
    for g, w in zip(got, want):  # NCDHW against NTHWC in 2x2 space-to-depth
        n, t, y, x2, c4 = w.shape  # channel order (py, px, c), a TPU layout
        w = np.asarray(w).reshape(n, t, y, x2, 2, 2, c4 // 4).transpose(0, 1, 2, 4, 3, 5, 6)
        np.testing.assert_array_equal(_np(g.permute(0, 2, 3, 4, 1)),
                                      w.reshape(n, t, 2 * y, 2 * x2, c4 // 4))
    plain = mm.normalize_and_prepare(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(plain[1].permute(0, 2, 3, 4, 1)),
                                  x[..., 5:7].astype(np.float32) * np.float32(1.0 / 255.0))


class _Float64Names:
    """``jax.numpy`` with ``float32`` read as ``float64``: put in place of
    ``layers.jnp`` for the float64 step, so ``BatchNormLean`` takes its
    statistics in float64."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def _jax_step(jt, variables, batch, step_rng, dtype):
    """One JAX train step of ``jt`` at ``dtype`` from ``variables``: the
    loss, and as torch state_dicts (float32) the gradients, the state after
    the step and what the step moved (after minus before, taken at
    ``dtype``)."""
    lr = float(jt.cfg.MODEL.LR)
    jt.cfg.TPU.COMPUTE_DTYPE = jt.cfg.TPU.PARAM_DTYPE = dtype
    jt.model = jt.model.clone(dtype=jnp.dtype(dtype), param_dtype=jnp.dtype(dtype))
    cast = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), variables)
    jt.state = TrainState.create(apply_fn=jt.model.apply, params=cast["params"],
                                 batch_stats=cast["batch_stats"],
                                 tx=optax.chain(_record_grads(), optax.sgd(lr, momentum=0.9)))
    state, metrics = jt._build_train_step()(jt.state, batch["x"], batch["label"],
                                            np.ones(BATCH, dtype), step_rng)
    after = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
    moved = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - b, after, cast)
    return (float(metrics["loss"]),
            state_dict_from_jax({"params": jax.device_get(state.opt_state[0])}),
            state_dict_from_jax(after), state_dict_from_jax(moved))


def _port_step(cfg, io, variables, batch, offsets, dtype):
    c = cfg.clone()
    c.CUDA.COMPUTE_DTYPE = c.CUDA.PARAM_DTYPE = dtype
    pt = V2Trainer(c, io=io, device="cpu")
    pt.model.load_state_dict(state_dict_from_jax(variables))
    pt.model.blocks[6].dropout_rate = 0.0
    assert isinstance(pt.optimizer, torch.optim.SGD)
    assert pt.optimizer.defaults["momentum"] == 0.9
    assert pt.optimizer.defaults["lr"] == float(cfg.MODEL.LR)
    m = pt.train_step(torch.from_numpy(batch["x"]), torch.from_numpy(batch["label"]),
                      offsets=torch.from_numpy(offsets))
    after = {k: v.clone() for k, v in pt.model.state_dict().items()}
    before = state_dict_from_jax(variables)
    return (float(m["loss"]), {k: p.grad.clone() for k, p in pt.model.named_parameters()},
            after, {k: v - before[k].to(v.dtype) for k, v in after.items()})


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    root = tmp_path_factory.mktemp("v2_trainer")
    io, cfg = Cv2FrameIO(), _configure(get_cfg(), root)
    generate_raw_fixture(cfg, num_videos_per_set=BATCH, num_classes=3, num_frames=10,
                         sets=SETS, io=io)
    stages.sample_data(cfg, SETS)
    run_v2_convert(cfg, io, "cpu", SyntheticIUVProvider(),
                   flow_params=FlowParams(n_outer=1, n_sor=2, min_width=16))

    jcfg = _configure(jax_get_cfg(), root)
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    jcfg.TPU.DONATE_STATE = False
    init = JaxTrainer._init_variables
    with pytest.MonkeyPatch.context() as mp:  # the weights are replaced: trace, don't compile
        mp.setattr(JaxTrainer, "_init_variables", lambda self: randomised_variables(
            jax.eval_shape(lambda: init(self)), seed=4))
        jt = JaxV2Trainer(jcfg, mesh=make_mesh(jcfg, devices=jax.devices()[:1]))
    variables = jax.device_get({"params": jt.state.params, "batch_stats": jt.state.batch_stats})
    jt.model = jt.model.clone(dropout_rate=0.0)
    cfg.CUDA.COMPUTE_DTYPE = "float32"
    pt = V2Trainer(cfg, io=io, device="cpu")
    pt.model.load_state_dict(state_dict_from_jax(variables))
    out = {"variables": variables, "jax_eval": jt.run_eval(), "port_eval": pt.run_eval()}

    batch = next(jax_train_batches(jt.train_dataset, BATCH, seed=0))
    step_rng = jax.random.PRNGKey(12)
    with jax.enable_x64(True):
        offsets = jax_crop_offsets(jax.random.split(step_rng)[0], BATCH, 64, 64, 64, 6)
        out["jax32"] = _jax_step(jt, variables, batch, step_rng, "float32")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_layers, "jnp", _Float64Names())
            out["jax64"] = _jax_step(jt, variables, batch, step_rng, "float64")
    for dtype in ("float32", "float64"):
        out["port" + dtype[-2:]] = _port_step(cfg, io, variables, batch, offsets, dtype)
    return out


def test_run_eval_matches_jax(parity):
    j, p = parity["jax_eval"], parity["port_eval"]
    assert p["sv"] == j["sv"] and len(p["sv"]) == BATCH
    np.testing.assert_array_equal(p["t"], j["t"])
    np.testing.assert_allclose(p["ps"], j["ps"], atol=5e-3, rtol=5e-3)
    assert p["acc"] == j["acc"]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _cos(a, b):
    return float(np.dot(a.ravel(), b.ravel()) / (np.linalg.norm(a) * np.linalg.norm(b)))


def _f64(d):
    return {k: _np(v).astype(np.float64) for k, v in d.items()}


def test_float64_step_matches_jax(parity):
    (port_loss, port_g, _, port_moved), (jax_loss, jax_g, _, jax_moved) = (
        parity["port64"], parity["jax64"])
    assert abs(port_loss - jax_loss) <= 1e-6 * abs(jax_loss), (port_loss, jax_loss)
    port_g, jax_g = _f64(port_g), _f64(jax_g)
    keys = sorted(jax_g)
    assert set(port_g) == set(keys)
    flat = np.concatenate
    assert _rel(flat([port_g[k].ravel() for k in keys]),
                flat([jax_g[k].ravel() for k in keys])) <= 1e-6
    for k in keys:
        assert _rel(port_g[k], jax_g[k]) <= 1e-6, (k, _rel(port_g[k], jax_g[k]))
    # What the step moved: SGD's -lr * g, the running statistics' pull.
    port_moved, jax_moved = _f64(port_moved), _f64(jax_moved)
    assert set(port_moved) == set(jax_moved) == set(state_dict_from_jax(parity["variables"]))
    for k, want in jax_moved.items():
        err = _rel(port_moved[k], want)
        assert np.any(want != 0) and err <= 1e-6, (k, err)


def test_train_step_loss_and_gradients_match_jax(parity):
    (port_loss, port_g, *_), (jax_loss, jax_g, *_), (exact_loss, exact, *_) = (
        parity["port32"], parity["jax32"], parity["jax64"])
    jax_gap = abs(jax_loss - exact_loss) / abs(exact_loss)
    assert abs(port_loss - jax_loss) <= max(1e-5, 2 * jax_gap) * abs(jax_loss), (
        port_loss, jax_loss, jax_gap)
    port, want, exact = _f64(port_g), _f64(jax_g), _f64(exact)
    keys = sorted(want)
    assert set(port) == set(exact) == set(keys)

    def flat(d):
        return np.concatenate([d[k].ravel() for k in keys])

    # JAX's float32 resolution: its float32 gradient against its float64 one.
    bar_all = max(1e-3, 2 * _rel(flat(want), flat(exact)))
    assert _rel(flat(port), flat(want)) <= bar_all, bar_all
    bar_each = max(1e-3, 2 * max(_rel(want[k], exact[k]) for k in keys))
    bar_cos = max(1e-3, 2 * max(1 - _cos(want[k], exact[k]) for k in keys))
    for k in keys:
        err, c = _rel(port[k], want[k]), _cos(port[k], want[k])
        assert err <= bar_each and 1 - c <= bar_cos, (k, err, c, bar_each, bar_cos)


def test_train_step_state_matches_jax(parity):
    after, want = parity["port32"][2], parity["jax32"][2]
    assert set(after) == set(want)
    for k, v in after.items():
        np.testing.assert_allclose(_np(v), want[k].numpy(), atol=5e-3, rtol=5e-3, err_msg=k)
    before = state_dict_from_jax(parity["variables"])
    assert any(not torch.equal(before[k], after[k]) for k in after if "running_" in k)
    assert any(not torch.equal(before[k], after[k]) for k in after if "running_" not in k)
