"""The port's v2 ``ChalearnGestureDataset`` (``v2/dataset.py``) against the
JAX package's (CPU, cv2 I/O).

The JAX package writes the v2 folders of a raw fixture (two 10-frame 48x64
videos per set, small flow, the synthetic provider); the box pickle of one
train video is then rewritten so that the union box of its parts is 32x32,
exactly twice ``MODEL.INPUT_SIZE`` (16) on both sides: OpenCV resizes that
7-channel crop by its area rule, which ``ops/image.resize_linear_u8``
reproduces (counted here). Both packages' datasets read the same folders:

  * the train clips equal, for the same ``random.Random`` seeds;
  * the eval clips and their counts equal (uniform sampling strides by
    CLIP_LEN; seq_len = len(boxes) - 1);
  * the samplers equal over a range of sequence lengths;
  * the exact-2x crop of 5-8 channels equal to cv2 (2x2 -> 1x1 too).
"""

import pickle
import random

import cv2
import numpy as np
import pytest
import torch

import video_classification_tpu_torch.ops.image as image_ops
from video_classification_tpu.config import get_cfg as jax_get_cfg
from video_classification_tpu.data.fixture import generate_raw_fixture as jax_raw_fixture
from video_classification_tpu.ops import flow as jflow
from video_classification_tpu.pipeline import stages as jax_stages
from video_classification_tpu.pipeline.iuv_contract import (
    SyntheticIUVProvider as JaxSynthetic)
from video_classification_tpu.v2 import ChalearnGestureDataset as JaxDataset
from video_classification_tpu.v2 import convert as jconv
from video_classification_tpu_torch.config import get_cfg
from video_classification_tpu_torch.ops.image import resize_linear_u8
from video_classification_tpu_torch.pipeline.frame_io import ArrayFrameIO, Cv2FrameIO
from video_classification_tpu_torch.v2 import ChalearnGestureDataset, V2_CHANNELS
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)

SETS = ("train", "test")
SIZE = 16


def _configure(c, root):
    c.CHALEARN.ROOT = str(root)
    c.CHALEARN.CLIP_LEN = 4
    c.CHALEARN.NUM_CLASS = 2
    c.CHALEARN.SAMPLE_CLASS = 2
    c.MODEL.INPUT_SIZE = SIZE
    return c


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("v2_dataset")
    jcfg = _configure(jax_get_cfg(), root)
    jax_raw_fixture(jcfg, num_videos_per_set=2, num_classes=2, num_frames=10, sets=SETS)
    jax_stages.sample_data(jcfg, SETS)
    jconv.ConvertVideoToFlow(jcfg, jflow.FlowParams(fuse_level="interpret", n_outer=1,
                                                    n_sor=2, min_width=16)).convert()
    jconv.ConvertVideoToIUVPkl(jcfg, JaxSynthetic()).convert()
    jconv.ConvertIuvPklToUvVideo(jcfg).convert()
    jconv.ConvertIuvPklToPartBox(jcfg).convert()
    frame = [None] * 25
    frame[1], frame[4] = (6, 5, 30, 30), (10, 12, 38, 37)  # union (6, 5, 38, 37): 32x32
    with (root / "6_Box" / "train" / "002" / "M_00002.pkl").open("wb") as f:
        pickle.dump([list(frame) for _ in range(10)], f)
    return root


def _datasets(root, name_of_set):
    return (ChalearnGestureDataset(_configure(get_cfg(), root), name_of_set, io=Cv2FrameIO()),
            JaxDataset(_configure(jax_get_cfg(), root), name_of_set))


def test_train_clips_equal_jax(root, monkeypatch):
    calls = []
    area = image_ops._area_2x_u8
    monkeypatch.setattr(image_ops, "_area_2x_u8", lambda x: calls.append(x.shape) or area(x))
    port, jax_ds = _datasets(root, "train")
    assert len(port) == len(jax_ds) == 2
    for index in range(2):
        for seed in (0, 1, 7):
            got = port.get_train_clip(index, random.Random(seed))
            want = jax_ds.get_train_clip(index, random.Random(seed))
            assert got["label"] == want["label"] == index
            assert got["x"].shape == (4, SIZE, SIZE, V2_CHANNELS) and got["x"].dtype == np.uint8
            np.testing.assert_array_equal(got["x"], want["x"])
    assert calls and all(s == (4, 32, 32, V2_CHANNELS) for s in calls)  # M_00002's crops


@pytest.mark.parametrize("name_of_set", SETS)
def test_eval_clips_equal_jax(root, name_of_set):
    port, jax_ds = _datasets(root, name_of_set)
    for index in range(len(jax_ds)):
        got = port.get_eval_clips(index, random.Random(index))
        want = jax_ds.get_eval_clips(index, random.Random(index))
        assert port.num_eval_clips(index) == jax_ds.num_eval_clips(index) == len(want["clips"])
        assert len(got["clips"]) == len(want["clips"]) == 2  # seq_len 9, clips of 4
        assert got["label"] == want["label"]
        for g, w in zip(got["clips"], want["clips"]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seq_len", [1, 3, 4, 5, 9, 17, 40])
def test_samplers_equal_jax(root, seq_len):
    port, jax_ds = _datasets(root, "train")
    for seed in range(5):
        assert (port._random_sampling(seq_len, random.Random(seed))
                == jax_ds._random_sampling(seq_len, random.Random(seed)))
        assert (port._uniform_sampling(seq_len, random.Random(seed))
                == jax_ds._uniform_sampling(seq_len, random.Random(seed)))


def test_the_card_backend_reads_the_same_clips(root, tmp_path):
    """The same folders rewritten as ArrayFrameIO stacks (the decoded cv2
    frames, losslessly) give the same clips."""
    from video_classification_tpu_torch.v2 import VideoIO

    cv2_io, arr = VideoIO(Cv2FrameIO()), VideoIO(ArrayFrameIO())
    for src in root.rglob("*"):
        dst = tmp_path / src.relative_to(root)
        if src.is_dir():
            dst.mkdir(parents=True, exist_ok=True)
        elif src.suffix == ".avi":
            arr.io.write_video(dst, cv2_io.io.read_video(src))
        else:
            dst.write_bytes(src.read_bytes())
    port = ChalearnGestureDataset(_configure(get_cfg(), tmp_path), "train", io=ArrayFrameIO())
    want, _ = _datasets(root, "train")
    for index in range(2):
        np.testing.assert_array_equal(port.get_train_clip(index, random.Random(3))["x"],
                                      want.get_train_clip(index, random.Random(3))["x"])


@pytest.mark.parametrize("c", [5, 6, 7, 8])
@pytest.mark.parametrize("src", [(2, 2), (32, 32), (128, 96)])
def test_exact_2x_crops_equal_cv2(c, src):
    crops = np.random.RandomState(c * src[0]).randint(0, 256, (3,) + src + (c,)).astype(
        np.uint8)
    dst = (src[0] // 2, src[1] // 2)
    want = np.stack([cv2.resize(x, dst[::-1], interpolation=cv2.INTER_LINEAR) for x in crops])
    got = resize_linear_u8(torch.from_numpy(crops), dst).numpy()
    np.testing.assert_array_equal(got, want.reshape(got.shape))
