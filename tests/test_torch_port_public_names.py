"""The last public names of the port against their JAX functions (CPU).

  * ``utils.Labels`` reads what the JAX ``Labels`` reads;
  * ``utils.StepTimer`` keeps the JAX timer's statistics (warm-up left out),
    and ``utils.trace`` writes a Chrome trace of ``torch.profiler`` into its
    log directory;
  * ``ops.denormalize_to_uint8`` and ``ops.pad2x`` equal the JAX functions;
  * ``ops.uniform_clip_indices_device`` equals the JAX one for every video
    length around the clip length, and ``ops.random_clip_indices_device``
    draws, from an explicit generator on the tensor's device, exactly the
    windows the JAX sampler can draw.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_classification_tpu import ops as jops
from video_classification_tpu import utils as jutils
from video_classification_tpu.config import get_cfg as jax_get_cfg
from video_classification_tpu_torch import ops, utils
from video_classification_tpu_torch.config import get_cfg
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)


def test_labels_read_what_the_jax_labels_read(tmp_path):
    jcfg, cfg = jax_get_cfg(), get_cfg()
    for c in (jcfg, cfg):
        c.CHALEARN.ROOT = str(tmp_path)
    entries = [(f"train/{i:03d}/M_{i:05d}.avi", f"train/{i:03d}/K_{i:05d}.avi", i % 7 + 1)
               for i in range(9)]
    utils.write_labels(cfg, "train", entries)
    want, got = jutils.Labels(jcfg), utils.Labels(cfg)
    assert got.sample_root == want.sample_root
    assert got.from_set("train") == want.from_set("train") == entries
    with pytest.raises(ValueError):
        got.from_set("val")


def test_step_timer_keeps_the_jax_statistics(monkeypatch):
    import time

    timers = (jutils.StepTimer(warmup=2), utils.StepTimer(warmup=2))
    for timer in timers:
        ticks = iter([0.0, 1.0, 1.0, 3.0, 3.0, 3.5, 3.5, 4.0, 4.0, 4.25])
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        for _ in range(5):
            with timer:
                pass
    want, got = timers
    assert got.times == want.times == [0.5, 0.5, 0.25]
    assert got.mean == want.mean and got.throughput(8) == want.throughput(8)
    assert np.isnan(utils.StepTimer().mean) and np.isnan(utils.StepTimer().throughput(1))


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "profile"
    with utils.trace(logdir) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    events = json.loads((logdir / "trace.json").read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_denormalize_and_pad2x_match_jax():
    rng = np.random.RandomState(0)
    x = rng.normal(0, 1.5, (2, 5, 7, 3)).astype(np.float32)
    x[0, 0, 0] = [-2.0, 0.0, 1.0 / 0.225]  # clipped low, mid, clipped high
    got = ops.denormalize_to_uint8(torch.from_numpy(x))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.denormalize_to_uint8(x)))
    u8 = rng.randint(0, 256, (2, 3, 5, 7, 3)).astype(np.uint8)
    np.testing.assert_array_equal(ops.normalize(torch.from_numpy(u8)).numpy(),
                                  np.asarray(jops.normalize(jnp.asarray(u8))))
    np.testing.assert_array_equal(
        ops.denormalize_to_uint8(ops.normalize(torch.from_numpy(u8))).numpy(), u8)
    for shape in ((5, 7, 3), (2, 3, 6, 9, 1)):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        np.testing.assert_array_equal(ops.pad2x(torch.from_numpy(img)).numpy(),
                                      np.asarray(jops.pad2x(jnp.asarray(img))))


@pytest.mark.parametrize("clip_len", [1, 4, 20])
def test_uniform_clip_indices_device_matches_jax(clip_len):
    for seq_len in range(1, clip_len + 30):
        idx, mask = ops.uniform_clip_indices_device(torch.tensor(seq_len), clip_len, 12)
        jidx, jmask = jops.uniform_clip_indices_device(jnp.int32(seq_len), clip_len, 12)
        assert idx.dtype == torch.int32 and mask.dtype == torch.bool
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        assert int(mask.sum()) == min(12, ops.num_uniform_clips(seq_len, clip_len))


@pytest.mark.parametrize("seq_len,clip_len", [(30, 20), (20, 20), (7, 20), (1, 4), (9, 4)])
def test_random_clip_indices_device_draws_the_jax_windows(seq_len, clip_len):
    gen = torch.Generator().manual_seed(0)
    got = {tuple(ops.random_clip_indices_device(gen, torch.tensor(seq_len), clip_len).tolist())
           for _ in range(400)}
    keys = jax.random.split(jax.random.PRNGKey(0), 400)
    want = {tuple(np.asarray(jops.random_clip_indices_device(k, seq_len, clip_len)).tolist())
            for k in keys}
    assert got == want and len(got) == max(0, seq_len - clip_len) + 1
    again = ops.random_clip_indices_device(torch.Generator().manual_seed(0),
                                           torch.tensor(seq_len), clip_len)
    first = ops.random_clip_indices_device(torch.Generator().manual_seed(0),
                                           torch.tensor(seq_len), clip_len)
    assert torch.equal(again, first) and again.dtype == torch.int32
