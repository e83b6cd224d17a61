"""The res3d and res2d stream models of the PyTorch port against the JAX
package (CPU, float32).

  * ``Res3D`` (pytorchvideo ``slow_r50`` names) and ``ResNet50_2D``
    (torchvision ``resnet50`` names) on numpy-seeded weights carried by
    ``models/convert.state_dict_from_jax``, depth 18 and 50: logits within
    5e-3 in eval mode, and in train mode (dropout 0) the logits and the new
    running statistics within 5e-3;
  * ``ModelManager``: res3d takes BGR+UV as NCDHW; res2d stacks the T
    frames x 5 channels T-major into NCHW, equal to the JAX package's
    ``_finish_res2d``; with crop offsets derived from the JAX key, equal to
    the JAX crops;
  * one ``Trainer.train_step`` of each model against the JAX trainer's
    (one-device mesh, dropout 0, JAX-derived crop offsets): loss within
    1e-5 relative, the running statistics within 5e-3, and the gradients at
    float32's measured resolution for the network (the rule of
    ``chip_smoke.gradient_gaps``): the same step in float64 is the exact
    gradient, and the port may sit from the JAX gradient twice as far as the
    JAX gradient sits from it, over all tensors and per tensor (or 1e-3, if
    larger), at a cosine >= 0.999. Measured at depth 18 (res2d at 192 px,
    res3d at 64 px): the JAX gradient is 0.5-1.1e-2 from the float64 one and
    moves by 0.4-1.5e-2 when the batch rows are permuted, so a flat 1e-3 is
    finer than float32 resolves here, as test_torch_port_trainer.py found
    for SlowFast.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from video_classification_tpu.config import get_cfg as jax_get_cfg
from video_classification_tpu.data.dataset import train_batches as jax_train_batches
from video_classification_tpu.engine import Trainer as JaxTrainer
from video_classification_tpu.engine.model_manager import ModelManager as JaxMM
from video_classification_tpu.engine.trainer import TrainState
from video_classification_tpu.models.res3d import Res3D as JaxRes3D
from video_classification_tpu.models.resnet2d import ResNet50_2D as JaxRes2D
from video_classification_tpu.parallel import make_mesh
from video_classification_tpu_torch.config import get_cfg
from video_classification_tpu_torch.engine import ModelManager, Trainer
from video_classification_tpu_torch.models import Res3D, ResNet50_2D, state_dict_from_jax
from test_torch_port_train_ops import jax_crop_offsets
from test_torch_port_trainer import _np, _record_grads
from torch_port_support import one_torch_thread, randomised_variables  # noqa: F401

DEPTHS = {18: (1, 1, 1, 1), 50: (3, 4, 6, 3)}
BATCH = 4


def _models(arch, depth):
    if arch == "res3d":
        x = np.random.RandomState(depth).normal(size=(2, 4, 32, 32, 5)).astype(np.float32)
        return (JaxRes3D(3, depths=DEPTHS[depth], dropout_rate=0.0),
                Res3D(3, depths=DEPTHS[depth], dropout_rate=0.0), x,
                lambda a: torch.from_numpy(a).permute(0, 4, 1, 2, 3))
    # 64 px: the last stage keeps 2x2 positions, so train-mode BN normalizes
    # over 8 values per channel, not 2 (ill-conditioned in float32).
    x = np.random.RandomState(depth).normal(size=(2, 64, 64, 20)).astype(np.float32)
    return (JaxRes2D(3, depths=DEPTHS[depth]),
            ResNet50_2D(3, in_channels=20, depths=DEPTHS[depth]), x,
            lambda a: torch.from_numpy(a).permute(0, 3, 1, 2))


@pytest.mark.parametrize("arch,depth", [("res3d", 18), ("res3d", 50), ("res2d", 18),
                                        ("res2d", 50)])
def test_model_matches_jax(arch, depth):
    jm, pm, x, to_port = _models(arch, depth)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = randomised_variables(shapes, seed=depth)
    sd = state_dict_from_jax(variables)
    assert set(sd) == set(pm.state_dict())
    pm.load_state_dict(sd)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    got = pm.eval()(to_port(x)).detach().numpy()
    assert got.shape == want.shape == (2, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=5e-3)

    want, mutated = jax.jit(lambda v, a: jm.apply(v, a, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    got = pm.train()(to_port(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=5e-3, rtol=5e-3)
    new_stats = state_dict_from_jax({"batch_stats": jax.device_get(mutated["batch_stats"])})
    after = pm.state_dict()
    for k, v in new_stats.items():
        np.testing.assert_allclose(after[k].numpy(), v.numpy(), atol=5e-3, rtol=5e-3,
                                   err_msg=k)
    assert not torch.equal(after[k], sd[k])  # the statistics did move


def test_res3d_head_dropout_draws_from_the_generator():
    model = Res3D(3, depths=DEPTHS[18]).train()
    x = torch.randn(2, 5, 2, 16, 16)
    with pytest.raises(ValueError, match="Generator"):
        model(x)
    a = model(x, torch.Generator().manual_seed(1))
    b = model(x, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)


def _configure(c, arch, root):
    c.CHALEARN.ROOT = str(root)
    c.CHALEARN.NUM_CLASS = 3
    c.CHALEARN.CLIP_LEN = 4
    c.CHALEARN.BATCH_SIZE = BATCH
    c.MODEL.NAME = arch
    # res2d at 192 px: its last stage keeps 6x6 positions per clip, so the
    # train-mode BN statistics there are not ill-conditioned in float32.
    c.MODEL.R3D_INPUT = "CropHTAH" if arch == "res2d" else "CropLHand"
    c.MODEL.DEPTH = 18
    c.DATA.SYNTHETIC_NUM_VIDEOS = 8
    c.DATA.SYNTHETIC_SEQ_LEN = 6
    return c


@pytest.mark.parametrize("arch", ["res3d", "res2d"])
def test_prepare_matches_jax(arch, tmp_path):
    jcfg = _configure(jax_get_cfg(), arch, tmp_path)
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    cfg = _configure(get_cfg(), arch, tmp_path)
    cfg.CUDA.COMPUTE_DTYPE = "float32"
    x = np.random.RandomState(0).randint(0, 256, (3, 4, 20, 20, 21)).astype(np.uint8)
    mm, jmm = ModelManager(cfg, torch.device("cpu")), JaxMM(jcfg)
    key = jax.random.PRNGKey(5)
    offsets = jax_crop_offsets(key, 3, 20, 20, mm.crop_size, mm.crop_padding)
    for got, want in ((mm.normalize_and_prepare(torch.from_numpy(x)),
                       jmm.normalize_and_prepare(jnp.asarray(x))),
                      (mm.normalize_and_prepare(torch.from_numpy(x), torch.from_numpy(offsets)),
                       jmm.normalize_and_prepare(jnp.asarray(x), augment_rng=key))):
        want = np.asarray(want)
        if arch == "res2d":  # NCHW, channel t * 5 + c
            assert got.shape == (3, 20) + want.shape[1:3]
            np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
        else:
            assert got.shape == (3, 5) + want.shape[1:4]
            np.testing.assert_array_equal(got.permute(0, 2, 3, 4, 1).numpy(), want)


@pytest.fixture(scope="module", params=["res3d", "res2d"])
def parity(request, tmp_path_factory):
    arch = request.param
    root = tmp_path_factory.mktemp(f"{arch}_parity")
    jcfg = _configure(jax_get_cfg(), arch, root / "jax")
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    jcfg.TPU.DONATE_STATE = False
    jt = JaxTrainer(jcfg, mesh=make_mesh(jcfg, devices=jax.devices()[:1]))
    variables = randomised_variables(
        {"params": jt.state.params, "batch_stats": jt.state.batch_stats}, seed=7)
    tx = optax.chain(_record_grads(), optax.adam(float(jcfg.MODEL.LR)))
    if arch == "res3d":
        jt.model = jt.model.clone(dropout_rate=0.0)
    jt.state = TrainState.create(apply_fn=jt.model.apply, params=variables["params"],
                                 batch_stats=variables["batch_stats"], tx=tx)
    jt._train_step = jt._build_train_step()

    cfg = _configure(get_cfg(), arch, root / "port")
    cfg.CUDA.COMPUTE_DTYPE = "float32"
    pt = Trainer(cfg, device="cpu")
    pt.model.load_state_dict(state_dict_from_jax(variables))
    if arch == "res3d":
        pt.model.blocks[5].dropout_rate = 0.0

    batch = next(jax_train_batches(jt.train_dataset, BATCH, seed=0))
    step_rng = jax.random.PRNGKey(11)
    size = pt.mm.crop_size
    offsets = torch.from_numpy(jax_crop_offsets(jax.random.split(step_rng)[0], BATCH, size,
                                                size, size, size // 10))
    state, metrics = jt._train_step(jt.state, batch["x"], batch["label"],
                                    np.ones(BATCH, np.float32), step_rng)
    out = {"arch": arch, "jax_loss": float(metrics["loss"])}
    out["jax_grads"] = {k: v.double().numpy() for k, v in state_dict_from_jax(
        {"params": jax.device_get(state.opt_state[0])}).items()}
    out["jax_stats"] = state_dict_from_jax({"batch_stats": jax.device_get(state.batch_stats)})
    x, labels = torch.from_numpy(batch["x"]), torch.from_numpy(batch["label"])
    m = pt.train_step(x, labels, offsets=offsets)
    out["port_loss"] = float(m["loss"])
    out["port_grads"] = {k: p.grad.double().numpy() for k, p in pt.model.named_parameters()}
    out["port_state"] = {k: v.clone() for k, v in pt.model.state_dict().items()}
    f64 = cfg.clone()
    f64.CUDA.COMPUTE_DTYPE = f64.CUDA.PARAM_DTYPE = "float64"
    exact = Trainer(f64, device="cpu")
    exact.model.load_state_dict(state_dict_from_jax(variables))
    if arch == "res3d":
        exact.model.blocks[5].dropout_rate = 0.0
    exact.train_step(x, labels, offsets=offsets)
    out["exact_grads"] = {k: p.grad.numpy() for k, p in exact.model.named_parameters()}
    return out


def test_train_step_loss_and_gradients_match_jax(parity):
    np.testing.assert_allclose(parity["port_loss"], parity["jax_loss"], rtol=1e-5)
    want, port, exact = parity["jax_grads"], parity["port_grads"], parity["exact_grads"]
    assert set(want) == set(port) == set(exact)
    keys = sorted(want)

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    def flat(d):
        return np.concatenate([d[k].ravel() for k in keys])

    bar_all = max(1e-3, 2 * rel(flat(want), flat(exact)))
    bar_each = max(1e-3, 2 * max(rel(want[k], exact[k]) for k in keys))
    assert rel(flat(port), flat(want)) <= bar_all, (parity["arch"], bar_all)
    for k in keys:
        err = rel(port[k], want[k])
        cos = float(np.dot(port[k].ravel(), want[k].ravel())
                    / (np.linalg.norm(port[k]) * np.linalg.norm(want[k])))
        assert err <= bar_each and cos >= 0.999, (k, err, cos, bar_each)


def test_train_step_running_statistics_match_jax(parity):
    got, want = parity["port_state"], parity["jax_stats"]
    assert want and set(want) <= set(got)
    for k, v in want.items():
        np.testing.assert_allclose(_np(got[k]), v.numpy(), atol=5e-3, rtol=5e-3, err_msg=k)
