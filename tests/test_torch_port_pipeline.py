"""Device-preprocessing parity of the PyTorch port against the JAX package
(CPU): the image ops, and ``preprocess_clip_on_device`` for every crop
stream on the same frames, flow images and synthetic detections."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_classification_tpu.ops import image as jimage
from video_classification_tpu.pipeline import device_pipeline as jdp
from video_classification_tpu.pipeline.online import (
    SyntheticOnlineDetector as JaxDetector)
from video_classification_tpu_torch.ops import image as timage
from video_classification_tpu_torch.pipeline import device_pipeline as tdp
from video_classification_tpu_torch.pipeline.online import (
    OnlineVideoDataset, SyntheticOnlineDetector)
from video_classification_tpu_torch.config import get_cfg
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("hw,size", [((37, 52), 64), ((52, 37), 128), ((20, 20), 64)])
def test_pad_to_square_resize_matches_jax(hw, size):
    img = np.random.RandomState(0).rand(60, 60, 4).astype(np.float32) * 255
    want = np.asarray(jimage.pad_to_square_resize(jnp.asarray(img), size, hw=hw))
    got = timage.pad_to_square_resize(
        torch.from_numpy(img)[None], size,
        hw=(torch.tensor([hw[0]]), torch.tensor([hw[1]])))[0].numpy()
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_shift2d_matches_jax():
    img = np.random.RandomState(1).randint(0, 256, (2, 9, 11, 3)).astype(np.uint8)
    shifts = [(3, -2), (-4, 5)]
    got = timage.shift2d(torch.from_numpy(img), torch.tensor([s[0] for s in shifts]),
                         torch.tensor([s[1] for s in shifts]), (7, 12)).numpy()
    for i, (dy, dx) in enumerate(shifts):
        want = np.asarray(jimage.shift2d(jnp.asarray(img[i]), dy, dx, (7, 12)))
        np.testing.assert_array_equal(got[i], want)


def test_preprocess_all_streams_match_jax():
    """All six crop streams (64/128/192 px) from 11 raw frames with their
    flow images given, so this isolates the canvas, CC boxes and resize."""
    rng = np.random.RandomState(2)
    t, h, w = 11, 64, 96
    frames = rng.randint(0, 256, (t, h, w, 3)).astype(np.uint8)
    depth = rng.randint(0, 256, (t, h, w, 1)).astype(np.uint8)
    flows = rng.randint(0, 256, (t, h, w, 3)).astype(np.uint8)
    padded = np.zeros((2, 2 * h, 2 * w, 3), np.uint8)
    jd = JaxDetector()(padded)
    want = jdp.preprocess_clip_on_device(
        jnp.asarray(frames), jnp.asarray(depth), jd, interval=5,
        flow_images=jnp.asarray(flows), sampled_start=5)
    td = SyntheticOnlineDetector()(torch.from_numpy(padded))
    got = tdp.preprocess_clip_on_device(
        torch.from_numpy(frames), torch.from_numpy(depth), td, interval=5,
        flow_images=torch.from_numpy(flows), sampled_start=5)
    assert set(got) == set(want)
    for key in want:
        g, wnt = got[key].numpy(), np.asarray(want[key])
        assert g.shape == wnt.shape, key
        if key.endswith("_valid"):
            np.testing.assert_array_equal(g, wnt)
            continue
        diff = np.abs(g.astype(np.int32) - wnt.astype(np.int32))
        assert float((diff <= 1).mean()) >= 0.999, (key, float((diff <= 1).mean()))


def test_virtual_window_matches_jax():
    from video_classification_tpu.pipeline.online import OnlineVideoDataset as JaxDS

    cfg = get_cfg()
    cfg.MODEL.R3D_INPUT = "CropLHand"
    frames = np.zeros((30, 8, 8, 3), np.uint8)
    ds = OnlineVideoDataset(cfg, "test", videos={0: (frames, None)}, device="cpu")
    for sampled in ([0, 1, 2], [3, 4, 5, 6], [5]):
        want = JaxDS._virtual_window(ds, sampled, 30)
        np.testing.assert_array_equal(ds._virtual_window(sampled, 30), want)
    assert ds.num_eval_clips(0) == 1 and ds._seq_len_sampled(0) == 6
