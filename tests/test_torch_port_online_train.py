"""The train side of the online dataset in the PyTorch port against the JAX
package (CPU): ``OnlineVideoDataset(cfg, "train")`` on the same in-memory
frames (the JAX dataset's decode cache filled here; the port's ``videos``),
the same labels and the same ``random.Random`` seeds, at 64x96 with the
reduced flow of the verify recipe (1 outer, 2 sweeps, min width 16), CLIP_LEN
2, CropLHand:

  * the same sampled windows (sequence lengths, and each generator left in
    the same state), the same labels and clip shapes;
  * clips within uint8 +-1 on >= 99.9 % (the flow golden bar);
  * ``train_batches`` over the port dataset stacks the clips as tensors, in
    the JAX batcher's order;
  * the port dataset reads its label file when given none, and refuses an
    unknown set.
"""

import random

import numpy as np
import pytest
import torch

from video_classification_tpu.config import get_cfg as jax_get_cfg
from video_classification_tpu.data.dataset import train_batches as jax_train_batches
from video_classification_tpu.pipeline.online import OnlineVideoDataset as JaxDS
from video_classification_tpu_torch.config import get_cfg
from video_classification_tpu_torch.data.dataset import train_batches
from video_classification_tpu_torch.pipeline.online import OnlineVideoDataset
from video_classification_tpu_torch.utils.labels import write_labels
from video_classification_tpu_torch.utils.synthetic import coherent_motion_frames
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)

LABELS = [(f"train/00{i}/M_0000{i}.avi", f"train/00{i}/K_0000{i}.avi", i + 1)
          for i in range(3)]


def _configure(c, root):
    c.CHALEARN.ROOT = str(root)
    c.CHALEARN.NUM_CLASS = 3
    c.CHALEARN.CLIP_LEN = 2
    c.CHALEARN.BATCH_SIZE = 3
    c.MODEL.R3D_INPUT = "CropLHand"
    c.DATA.FLOW_OUTER = 1
    c.DATA.FLOW_SOR = 2
    c.DATA.FLOW_MIN_WIDTH = 16
    return c


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("online_train")
    videos = {}
    for i, t in enumerate((34, 27, 9)):  # 7, 6 and 2 sampled frames
        rgb = coherent_motion_frames(t, 64, 96, torch.Generator().manual_seed(30 + i)).numpy()
        depth = rgb.mean(-1, keepdims=True).astype(np.uint8)
        videos[i] = (rgb, depth)
    jds = JaxDS(_configure(jax_get_cfg(), root), "train", labels=LABELS)
    for i, frames in videos.items():
        jds._decode_cache[i] = frames
    pds = OnlineVideoDataset(_configure(get_cfg(), root), "train", labels=LABELS,
                             videos=videos, device="cpu")
    return jds, pds


def _within(a, b):
    return float((np.abs(a.astype(np.int32) - b.astype(np.int32)) <= 1).mean())


@pytest.mark.parametrize("index,seed", [(0, 0), (0, 7), (1, 3), (2, 1)])
def test_get_train_clip_matches_jax(datasets, index, seed):
    jds, pds = datasets
    assert len(pds) == len(jds) and pds.sampling == jds.sampling == "random"
    assert pds._seq_len_sampled(index) == jds._seq_len_sampled(index)
    rj, rp = random.Random(seed), random.Random(seed)
    want, got = jds.get_train_clip(index, rj), pds.get_train_clip(index, rp)
    assert rj.getstate() == rp.getstate()  # the same window was drawn
    assert got["label"] == want["label"] == LABELS[index][2] - 1
    assert isinstance(got["x"], torch.Tensor) and got["x"].dtype == torch.uint8
    assert tuple(got["x"].shape) == want["x"].shape == (2, 64, 64, 21)
    frac = _within(got["x"].numpy(), want["x"])
    assert frac >= 0.999, frac


def test_train_batches_of_online_clips(datasets):
    jds, pds = datasets
    (got,), (want,) = list(train_batches(pds, 3, seed=4)), list(jax_train_batches(jds, 3, seed=4))
    assert isinstance(got["x"], torch.Tensor) and got["x"].shape == (3, 2, 64, 64, 21)
    np.testing.assert_array_equal(got["label"], want["label"])
    assert _within(got["x"].numpy(), want["x"]) >= 0.999


def test_labels_from_the_label_file(tmp_path):
    cfg = _configure(get_cfg(), tmp_path)
    write_labels(cfg, "train", LABELS)
    ds = OnlineVideoDataset(cfg, "train", device="cpu")
    assert ds.labels == LABELS and len(ds) == 3 and ds.name_of_set == "train"
    assert OnlineVideoDataset(cfg, "test", labels=LABELS[:1], device="cpu").sampling == "uniform"
    with pytest.raises(ValueError):
        OnlineVideoDataset(cfg, "val", labels=LABELS, device="cpu")
