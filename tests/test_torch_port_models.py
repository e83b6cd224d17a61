"""Model parity of the PyTorch port against the JAX package (CPU, float32).

  * the weight carry: ``state_dict_from_jax(variables)`` gives exactly the
    port model's state_dict keys and shapes, which equal the JAX package's
    own ``flax_to_torch`` export (pytorchvideo key grammar), for every
    fusion mode;
  * the depth-18 SlowFast eval forward with carried weights (BN statistics
    randomised) matches the flax model at atol = rtol = 5e-3;
  * normalisation and the pathway split match ``ModelManager``;
  * the port's checkpoints round-trip through tier 1 and tier 2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_classification_tpu.config import get_cfg as jax_get_cfg
from video_classification_tpu.engine.model_manager import ModelManager as JaxMM
from video_classification_tpu.models.slowfast import init_my_slowfast as jax_slowfast
from video_classification_tpu.models.torch_convert import flax_to_torch
from video_classification_tpu_torch.config import get_cfg
from video_classification_tpu_torch.engine import (
    ModelManager, ckpt_dir, load_checkpoint, save_checkpoint)
from video_classification_tpu_torch.models import init_my_slowfast, state_dict_from_jax
from video_classification_tpu_torch.models.convert import torch_module_name
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)

T, S, N = 4, 32, 2


def _cfgs(fusion="default", fuse=True, classes=7):
    jcfg = jax_get_cfg()
    cfg = get_cfg()
    for c in (jcfg, cfg):
        c.MODEL.DEPTH = 18
        c.MODEL.FUSION_MODE = fusion
        c.MODEL.FUSE = fuse
        c.CHALEARN.NUM_CLASS = classes
        c.MODEL.R3D_INPUT = "CropLHand"
        c.MODEL.NAME = "slowfast-LHand"
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.CUDA.COMPUTE_DTYPE = "float32"
    return jcfg, cfg


def _jax_variables(jcfg, seed=0):
    """The flax model's variable tree (shapes from ``jax.eval_shape``, no
    compile) filled from a numpy seed: conv/dense kernels N(0, 1/fan_in),
    BN scales, biases and statistics randomised."""
    model = jax_slowfast(jcfg)
    xs = [jnp.zeros((1, T, S, S, 5)), jnp.zeros((1, T, S, S, 15))]
    shapes = jax.eval_shape(functools.partial(model.init, train=False),
                            jax.random.PRNGKey(0), xs)
    rng = np.random.RandomState(seed)

    def fill(node, coll):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = fill(v, coll)
                continue
            shape = tuple(v.shape)
            if k == "kernel":
                a = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
            elif k == "mean":
                a = rng.normal(0, 0.2, shape)
            elif k == "var":
                a = rng.uniform(0.5, 1.5, shape)
            elif k == "scale":
                a = rng.normal(1, 0.2, shape)
            else:  # bias
                a = rng.normal(0, 0.2, shape)
            out[k] = a.astype(np.float32)
        return out

    return model, {c: fill(shapes[c], c) for c in ("params", "batch_stats")}


@pytest.mark.parametrize("fusion,fuse", [("default", True), ("C123", True),
                                         ("R", True), ("default", False)])
def test_state_dict_keys_and_shapes_match_flax_to_torch(fusion, fuse):
    jcfg, cfg = _cfgs(fusion, fuse)
    _, variables = _jax_variables(jcfg)
    carried = state_dict_from_jax(variables)
    exported = flax_to_torch(variables)
    model = init_my_slowfast(cfg)
    port = model.state_dict()
    assert set(carried) == set(exported) == set(port)
    for k, v in exported.items():
        assert tuple(carried[k].shape) == v.shape == tuple(port[k].shape), k
        np.testing.assert_array_equal(carried[k].numpy(), v)
    model.load_state_dict(carried)  # strict


@pytest.mark.parametrize("fusion", ["default", "C123", "R"])
def test_slowfast_eval_forward_matches_flax(fusion):
    jcfg, cfg = _cfgs(fusion)
    jmodel, variables = _jax_variables(jcfg, seed=1)
    rng = np.random.RandomState(2)
    slow = rng.normal(0, 1, (N, T, S, S, 5)).astype(np.float32)
    fast = rng.normal(0, 1, (N, T, S, S, 15)).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, [jnp.asarray(slow), jnp.asarray(fast)],
                                   train=False))
    model = init_my_slowfast(cfg)
    model.load_state_dict(state_dict_from_jax(variables))
    model.eval()
    with torch.no_grad():
        got = model([torch.from_numpy(slow).permute(0, 4, 1, 2, 3),
                     torch.from_numpy(fast).permute(0, 4, 1, 2, 3)])
    assert got.dtype == torch.float32 and got.shape == (N, 7)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3, rtol=5e-3)


def test_normalize_and_prepare_matches_jax():
    jcfg, cfg = _cfgs()
    x = np.random.RandomState(3).randint(0, 256, (N, T, S, S, 21)).astype(np.uint8)
    want = JaxMM(jcfg).normalize_and_prepare(jnp.asarray(x))
    got = ModelManager(cfg, torch.device("cpu")).normalize_and_prepare(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.permute(0, 2, 3, 4, 1).numpy(), np.asarray(w))


def test_unknown_jax_module_raises():
    with pytest.raises(KeyError):
        torch_module_name(("blocks_1_pathway_0", "mystery"))


def test_checkpoint_tiers(tmp_path):
    _, cfg = _cfgs()
    cfg.CHALEARN.ROOT = str(tmp_path)
    mm = ModelManager(cfg, torch.device("cpu"))
    model = mm.init_model()
    assert load_checkpoint(cfg, model) is None
    # Tier 2: a part stream falls back to the HTAH stream's checkpoint.
    htah = cfg.clone()
    htah.MODEL.NAME = "slowfast-HTAH"
    src = mm.init_model()
    with torch.no_grad():
        next(src.parameters()).add_(1.0)
    path = save_checkpoint(htah, src, epoch=3, acc=0.25)
    assert path.name == "acc0.250_e3.ckpt" and path.parent == ckpt_dir(htah)
    assert load_checkpoint(cfg, model) == path
    assert torch.equal(next(model.parameters()), next(src.parameters()))
    # Tier 1 wins once the stream has its own; the best accuracy sorts last.
    save_checkpoint(cfg, mm.init_model(), epoch=1, acc=0.5)
    best = save_checkpoint(cfg, mm.init_model(), epoch=2, acc=0.75)
    assert load_checkpoint(cfg, model) == best
