"""The DensePose provider's three resizes (``ops/image.resize_linear_u8``,
``resize_nearest``, ``resize_linear_f32``) against ``cv2.resize``, which
the JAX package's provider calls (detect/provider.py:110,162-164).

The bar is exact equality, on every value: upscales and downscales, the
provider's ResizeShortestEdge of a 480x640 padded frame to 800x1067,
1-pixel outputs and sources, an exact 2x downscale (which OpenCV runs as
INTER_AREA), and Hypothesis over sizes. Batched calls equal per-image
calls.

The v2 dataset's clips (7 channels, ``v2/dataset.py``) go through
``resize_linear_u8`` too: with more than 4 channels, an exact 2x downscale
on both axes is OpenCV's area mean (the 2x2 sum / 4 rounded half to even),
held here on 5-8 channels with Hypothesis over sizes (exact 2x and 2x2 ->
1x1 among them); with 3 and 4 channels the exact 2x case keeps the
fixed-point rule, and both agree with cv2.
"""

import cv2
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from video_classification_tpu_torch.detect.provider import resized_shape
from video_classification_tpu_torch.ops.image import (resize_linear_f32, resize_linear_u8,
                                                      resize_nearest)
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)


def _cv2(images, hw, interpolation):
    return np.stack([cv2.resize(im, (hw[1], hw[0]), interpolation=interpolation)
                     for im in images])


def _check(images, hw, seed_note=""):
    """All three resizes of a batch against cv2, exactly."""
    u8 = resize_linear_u8(torch.from_numpy(images), hw).numpy()
    np.testing.assert_array_equal(u8, _cv2(images, hw, cv2.INTER_LINEAR), err_msg=seed_note)
    charts = (images[..., 0] % 25).astype(np.uint8)
    nearest = resize_nearest(torch.from_numpy(charts), hw).numpy()
    np.testing.assert_array_equal(nearest, _cv2(charts, hw, cv2.INTER_NEAREST),
                                  err_msg=seed_note)
    fields = images[..., :2].astype(np.float32) / np.float32(255.0) + np.float32(1e-3)
    uv = resize_linear_f32(torch.from_numpy(fields.transpose(0, 3, 1, 2).reshape(
        -1, *fields.shape[1:3])), hw).numpy()
    want = _cv2(fields.transpose(0, 3, 1, 2).reshape(-1, *fields.shape[1:3]), hw,
                cv2.INTER_LINEAR)
    np.testing.assert_array_equal(uv, want, err_msg=seed_note)


def _images(rng, b, h, w):
    return rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)


def test_provider_resize_shortest_edge_480x640_to_800x1067():
    scale, hw = resized_shape(480, 640, 800, 1333)
    assert hw == (800, 1067) and scale == 800 / 480
    images = _images(np.random.RandomState(0), 1, 480, 640)
    got = resize_linear_u8(torch.from_numpy(images), hw).numpy()
    np.testing.assert_array_equal(got, _cv2(images, hw, cv2.INTER_LINEAR))


@pytest.mark.parametrize("src,dst", [
    ((112, 112), (1, 1)), ((112, 112), (1, 37)), ((112, 112), (53, 1)),
    ((112, 112), (240, 320)), ((112, 112), (57, 29)), ((56, 56), (131, 77)),
    ((48, 64), (80, 107)), ((96, 128), (64, 85)), ((64, 54), (53, 210)),
    ((112, 112), (56, 56)), ((1, 1), (5, 5)), ((9, 1), (23, 4)), ((1, 9), (3, 23)),
    ((2, 3), (7, 11)), ((7, 9), (7, 9))])
def test_edge_sizes_are_exact(src, dst):
    _check(_images(np.random.RandomState(sum(src + dst)), 2, *src), dst, f"{src}->{dst}")


@settings(max_examples=60, deadline=None, derandomize=True)
@given(h=st.integers(1, 140), w=st.integers(1, 140), oh=st.integers(1, 400),
       ow=st.integers(1, 400), seed=st.integers(0, 2 ** 16))
def test_random_sizes_are_exact(h, w, oh, ow, seed):
    _check(_images(np.random.RandomState(seed), 2, h, w), (oh, ow), f"seed {seed}")


def test_values_at_the_edges_of_the_range():
    """uint8 0 and 255 everywhere (the fixed-point sums at their largest),
    and float32 fields at 0 and 1."""
    for value in (0, 255):
        images = np.full((1, 37, 41, 3), value, np.uint8)
        _check(images, (100, 13))
    fields = np.random.RandomState(1).randint(0, 2, (2, 30, 30)).astype(np.float32)
    got = resize_linear_f32(torch.from_numpy(fields), (71, 44)).numpy()
    np.testing.assert_array_equal(got, _cv2(fields, (71, 44), cv2.INTER_LINEAR))


def test_bad_inputs_raise():
    with pytest.raises(ValueError):
        resize_linear_u8(torch.zeros((1, 4, 4, 3), dtype=torch.float32), (2, 2))
    with pytest.raises(ValueError):
        resize_linear_f32(torch.zeros((1, 4, 4)), (0, 2))
    with pytest.raises(ValueError):
        resize_nearest(torch.zeros((4, 4), dtype=torch.uint8), (2, 2))


def _u8_check(images, hw, note=""):
    got = resize_linear_u8(torch.from_numpy(images), hw).numpy()
    want = _cv2(images, hw, cv2.INTER_LINEAR)
    np.testing.assert_array_equal(got, want.reshape(got.shape), err_msg=note)


@pytest.mark.parametrize("c", [3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("src", [(2, 2), (4, 6), (128, 128), (128, 96), (58, 34)])
def test_exact_2x_downscale_every_channel_count(c, src):
    """> 4 channels: OpenCV's area rule; 3 and 4: the fixed-point rule, as
    before (the offline chain's 3-channel frames are unchanged)."""
    images = np.random.RandomState(c + src[0]).randint(0, 256, (2,) + src + (c,)).astype(
        np.uint8)
    _u8_check(images, (src[0] // 2, src[1] // 2), f"{src} x{c}")


def test_area_rule_rounds_half_to_even():
    """2x2 sums of 4k + 2 land on a half: 2, 6, 10 -> 0, 2, 2 (half to even)."""
    sums = np.asarray([2, 6, 10, 14, 1, 3, 1018, 1020], np.int64)
    images = np.zeros((1, 2, 16, 5), np.uint8)
    for i, total in enumerate(sums):  # spread each sum over a 2x2 block
        q, r = divmod(int(total), 4)
        block = np.full(4, q) + (np.arange(4) < r)
        images[0, :, 2 * i:2 * i + 2, :] = block.reshape(2, 2, 1)
    _u8_check(images, (1, 8))
    got = resize_linear_u8(torch.from_numpy(images), (1, 8)).numpy()[0, 0, :, 0]
    np.testing.assert_array_equal(got, np.rint(sums / 4).astype(np.uint8))


@settings(max_examples=60, deadline=None, derandomize=True)
@given(h=st.integers(1, 90), w=st.integers(1, 90), oh=st.integers(1, 140),
       ow=st.integers(1, 140), c=st.integers(5, 8), seed=st.integers(0, 2 ** 16),
       halve=st.booleans())
def test_random_sizes_with_5_to_8_channels_are_exact(h, w, oh, ow, c, seed, halve):
    if halve:  # an exact 2x downscale on both axes
        h, w, oh, ow = 2 * max(h // 2, 1), 2 * max(w // 2, 1), max(h // 2, 1), max(w // 2, 1)
    images = np.random.RandomState(seed).randint(0, 256, (2, h, w, c)).astype(np.uint8)
    _u8_check(images, (oh, ow), f"seed {seed}")
