"""The train step's small ops in the PyTorch port against the JAX package
(CPU, same numpy-seeded inputs):

  * RandomCrop: JAX PRNG draws cannot be reproduced in torch, so the
    offsets are derived from the JAX key exactly as ``random_crop_batch_mxu``
    and ``random_crop_batch`` derive them, checked to cover offset 0, the
    maximum and values in between, and handed to the port's
    ``random_crop_batch``: bit-equal to both JAX crops; ``random_crop`` of
    one clip; ``ModelManager.normalize_and_prepare`` with offsets against
    the JAX one with the same key; ``random_crop_offsets`` stays in range;
  * the segment functions, exactly, on the same scores; the softmax within
    1e-6 relative (the two frameworks' exp differ in the last bit);
  * the weighted cross-entropy (weight-0 rows included) within 1e-6;
  * ``torch.optim.Adam`` as the trainer configures it against
    ``optax.adam`` on the same injected gradients for 3 steps, within 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from video_classification_tpu.config import get_cfg as jax_get_cfg
from video_classification_tpu.engine.model_manager import ModelManager as JaxMM
from video_classification_tpu.ops import segment as jseg
from video_classification_tpu.ops.image import random_crop_batch as jax_crop
from video_classification_tpu.ops.image import random_crop_batch_mxu
from video_classification_tpu_torch.config import get_cfg
from video_classification_tpu_torch.engine.model_manager import ModelManager
from video_classification_tpu_torch.engine.trainer import weighted_cross_entropy
from video_classification_tpu_torch.ops import segment as pseg
from video_classification_tpu_torch.ops.image import (
    random_crop, random_crop_batch, random_crop_offsets)
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)


def jax_crop_offsets(key, n, h, w, size, padding):
    """(n, 2) offsets as ``random_crop_batch_mxu`` (and, key for key,
    ``random_crop_batch``) draw them from ``key``."""
    keys = jax.random.split(key, n)
    ky = jax.vmap(lambda k: jax.random.split(k)[0])(keys)
    kx = jax.vmap(lambda k: jax.random.split(k)[1])(keys)
    oy = jax.vmap(lambda k: jax.random.randint(k, (), 0, h + 2 * padding - size + 1))(ky)
    ox = jax.vmap(lambda k: jax.random.randint(k, (), 0, w + 2 * padding - size + 1))(kx)
    return np.stack([np.asarray(oy), np.asarray(ox)], axis=1)


@pytest.mark.parametrize("size,seed", [(10, 0), (20, 1), (21, 2)])
def test_random_crop_equals_jax_crops(size, seed):
    n, t, c = 24, 3, 4
    padding = size // 10
    clips = np.random.RandomState(seed).normal(size=(n, t, size, size, c)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    offsets = jax_crop_offsets(key, n, size, size, size, padding)
    top = 2 * padding
    for col in (0, 1):
        seen = set(offsets[:, col].tolist())
        assert {0, top} <= seen and (top < 2 or seen - {0, top}), (col, seen)

    got = random_crop_batch(torch.from_numpy(clips), torch.from_numpy(offsets),
                            size, padding).numpy()
    want_mxu = np.asarray(random_crop_batch_mxu(key, jnp.asarray(clips), size, padding))
    want = np.asarray(jax_crop(key, jnp.asarray(clips), size, padding))
    np.testing.assert_array_equal(got, want_mxu)
    np.testing.assert_array_equal(got, want)
    one = random_crop(torch.from_numpy(clips[3]), torch.from_numpy(offsets[3]), size, padding)
    np.testing.assert_array_equal(one.numpy(), want[3])


def test_normalize_and_prepare_with_offsets_matches_jax():
    jcfg, cfg = jax_get_cfg(), get_cfg()
    for c in (jcfg, cfg):
        c.MODEL.NAME = "slowfast-LHand"
        c.MODEL.R3D_INPUT = "CropLHand"
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.CUDA.COMPUTE_DTYPE = "float32"
    jmm, mm = JaxMM(jcfg), ModelManager(cfg, torch.device("cpu"))
    size = mm.crop_size
    x = np.random.RandomState(3).randint(0, 256, (5, 2, size, size, 21)).astype(np.uint8)
    key = jax.random.PRNGKey(7)
    offsets = jax_crop_offsets(key, 5, size, size, size, size // 10)
    got = mm.normalize_and_prepare(torch.from_numpy(x), torch.from_numpy(offsets))
    want = jmm.normalize_and_prepare(jnp.asarray(x), augment_rng=key)  # s2d layout
    for g, w in zip(got, want):
        w = np.asarray(w)
        n, t, hh, ww, c4 = w.shape
        w = w.reshape(n, t, hh, ww, 2, 2, c4 // 4).transpose(0, 1, 2, 4, 3, 5, 6)
        w = w.reshape(n, t, 2 * hh, 2 * ww, c4 // 4)
        np.testing.assert_array_equal(g.numpy(), np.transpose(w, (0, 4, 1, 2, 3)))


def test_random_crop_offsets_stay_in_range():
    g = torch.Generator().manual_seed(0)
    off = random_crop_offsets(4096, 64, 70, 64, 6, g)
    assert off.shape == (4096, 2) and off.dtype == torch.int64
    assert int(off[:, 0].min()) == 0 and int(off[:, 0].max()) == 12
    assert int(off[:, 1].min()) == 0 and int(off[:, 1].max()) == 18


def test_segment_functions_equal_jax():
    sv = [3, 1, 4, 2]
    total = sum(sv)
    seg = pseg.segment_ids_from_counts(sv, total)
    np.testing.assert_array_equal(seg, jseg.segment_ids_from_counts(sv, total))
    assert seg.dtype == np.int32
    with pytest.raises(ValueError):
        pseg.segment_ids_from_counts(sv, total + 1)
    rng = np.random.RandomState(4)
    logits = rng.normal(size=(total, 5)).astype(np.float32)
    labels = np.repeat(np.asarray([2, 0, 4, 1], np.int32), sv)
    labels[4] = 3  # a video whose clips disagree: its label is the minimum
    jscores = jseg.softmax_scores(jnp.asarray(logits))
    np.testing.assert_allclose(pseg.softmax_scores(torch.from_numpy(logits)).numpy(),
                               np.asarray(jscores), rtol=1e-6, atol=0)
    scores = torch.from_numpy(np.asarray(jscores))
    pv = pseg.per_video_scores(scores, torch.from_numpy(seg), len(sv))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(
        jseg.per_video_scores(jscores, jnp.asarray(seg), len(sv))))
    acc, correct = pseg.per_video_accuracy(scores, torch.from_numpy(labels),
                                           torch.from_numpy(seg), len(sv))
    jacc, jcorrect = jseg.per_video_accuracy(jscores, jnp.asarray(labels),
                                             jnp.asarray(seg), len(sv))
    assert float(acc) == float(jacc)
    np.testing.assert_array_equal(correct.numpy(), np.asarray(jcorrect))


def test_weighted_cross_entropy_matches_optax():
    rng = np.random.RandomState(5)
    logits = rng.normal(0, 3, (6, 7)).astype(np.float32)
    labels = rng.randint(0, 7, 6).astype(np.int32)
    labels[:2] = np.argmax(logits[:2], -1)  # some rows correct
    for weights in (np.ones(6, np.float32), np.asarray([1, 1, 0, 1, 0, 1], np.float32),
                    np.zeros(6, np.float32)):
        m = weighted_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels).long(),
                                   torch.from_numpy(weights))
        ce = optax.softmax_cross_entropy_with_integer_labels(jnp.asarray(logits),
                                                             jnp.asarray(labels))
        w = jnp.asarray(weights)
        want = jnp.sum(ce * w) / jnp.maximum(jnp.sum(w), 1.0)
        np.testing.assert_allclose(float(m["loss"]), float(want), atol=1e-6, rtol=1e-6)
        want_correct = jnp.sum((jnp.argmax(jnp.asarray(logits), -1) == labels) * w)
        assert float(m["correct"]) == float(want_correct)
        assert float(m["count"]) == float(weights.sum())


def test_adam_matches_optax_on_injected_gradients():
    rng = np.random.RandomState(6)
    lr = 5e-4
    shapes = {"a": (7, 3), "b": (11,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.randint(-8, 1, s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = torch.optim.Adam(tp.values(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    tx = optax.adam(lr)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    for g in grads:
        for k in shapes:
            tp[k].grad = torch.from_numpy(g[k])
        opt.step()
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       atol=1e-7, rtol=0)
