"""The data side of training in the PyTorch port against the JAX package
(CPU):

  * synthetic clips equal to the JAX dataset's, train and eval;
  * ``train_batches`` (order, clips, labels) and ``eval_batches`` (clips,
    labels, ``valid`` of the padded last batch, ``samples_per_video``) equal
    to the JAX batchers on the same dataset and seed;
  * the cv2 JPEG path on the JAX package's ``data/fixture.generate_fixture``
    crops (some frames missing), equal to the JAX cv2 path;
  * device tensors from a dataset are stacked as tensors;
  * the label files round-trip, and a bad set name raises;
  * ``prefetch_to_device`` keeps the order at every depth, hands a
    producer's exception to the consumer after the batches before it, and
    stops its thread when the consumer stops early;
  * ``DATA.BACKEND native`` raises where the native loader cannot be
    built (tests/test_torch_port_native_loader.py holds the loader itself).
"""

import random
import threading

import numpy as np
import pytest
import torch

from video_classification_tpu.config import get_cfg as jax_get_cfg
from video_classification_tpu.data import dataset as jds
from video_classification_tpu.data.fixture import generate_fixture
from video_classification_tpu_torch.config import get_cfg
from video_classification_tpu_torch.data import dataset as pds
from video_classification_tpu_torch.data.pipeline import prefetch_to_device
from video_classification_tpu_torch.utils.labels import get_labels, write_labels
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)


def _cfgs(root="/nonexistent", synthetic=7, clip_len=4, seq_len=9, crop="CropLHand"):
    jcfg, cfg = jax_get_cfg(), get_cfg()
    for c in (jcfg, cfg):
        c.CHALEARN.ROOT = str(root)
        c.CHALEARN.NUM_CLASS = 3
        c.CHALEARN.CLIP_LEN = clip_len
        c.MODEL.R3D_INPUT = crop
        c.DATA.SYNTHETIC_NUM_VIDEOS = synthetic
        c.DATA.SYNTHETIC_SEQ_LEN = seq_len
        c.DATA.BACKEND = "cv2"
    return jcfg, cfg


def _equal_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert type(g[k]) is np.ndarray and g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("name_of_set", ["train", "test"])
def test_synthetic_clips_equal_jax(name_of_set):
    jcfg, cfg = _cfgs()
    j, p = jds.ChalearnVideoDataset(jcfg, name_of_set), pds.ChalearnVideoDataset(cfg, name_of_set)
    assert p.labels == j.labels and len(p) == len(j) and p.sampling == j.sampling
    for i in range(len(j)):
        a, b = p.get_train_clip(i, random.Random(i)), j.get_train_clip(i, random.Random(i))
        assert a["label"] == b["label"] and a["x"].dtype == np.uint8
        assert torch.equal(torch.from_numpy(a["x"]), torch.from_numpy(b["x"]))
        assert p.num_eval_clips(i) == j.num_eval_clips(i)


@pytest.mark.parametrize("batch_size,seq_len", [(3, 9), (2, 30), (4, 3)])
def test_batchers_equal_jax(batch_size, seq_len):
    jcfg, cfg = _cfgs(seq_len=seq_len)
    j, p = jds.ChalearnVideoDataset(jcfg, "train"), pds.ChalearnVideoDataset(cfg, "train")
    for seed in (0, 5):
        _equal_batches(list(pds.train_batches(p, batch_size, seed=seed)),
                       list(jds.train_batches(j, batch_size, seed=seed)))
    gen, spv = pds.eval_batches(p, batch_size, seed=2)
    jgen, jspv = jds.eval_batches(j, batch_size, seed=2)
    assert spv == jspv
    got, want = list(gen), list(jgen)
    _equal_batches(got, want)
    assert sum(int(b["valid"].sum()) for b in got) == sum(spv)


def test_jpeg_fixture_path_equals_jax(tmp_path):
    jcfg, cfg = _cfgs(root=tmp_path, synthetic=0, clip_len=3)
    generate_fixture(jcfg, num_videos_per_set=3, num_classes=3, frames_per_video=5,
                     crops=("CropLHand",), sets=("train", "test"), seed=1)
    # A missing crop frame is filled with 127 by both.
    missing = sorted((tmp_path / "CropLHand").rglob("0000[05].jpg"))[0]
    missing.unlink()
    for name_of_set in ("train", "test"):
        j = jds.ChalearnVideoDataset(jcfg, name_of_set)
        p = pds.ChalearnVideoDataset(cfg, name_of_set)
        assert p.labels == j.labels
        _equal_batches(list(pds.train_batches(p, 2, seed=3, drop_last=False)),
                       list(jds.train_batches(j, 2, seed=3, drop_last=False)))
        gen, spv = pds.eval_batches(p, 2)
        jgen, jspv = jds.eval_batches(j, 2)
        assert spv == jspv
        _equal_batches(list(gen), list(jgen))


class _DeviceClips:
    """A dataset whose clips are tensors (as the online dataset's)."""

    labels = [(None, None, 1), (None, None, 2), (None, None, 3)]

    def __len__(self):
        return 3

    def get_train_clip(self, index, rng):
        return {"x": torch.full((2, 4, 4, 21), index, dtype=torch.uint8), "label": index}

    def get_eval_clips(self, index, rng):
        return {"clips": [torch.full((2, 4, 4, 21), index, dtype=torch.uint8)] * 2,
                "label": index}

    def num_eval_clips(self, index):
        return 2


def test_batchers_stack_tensors_as_tensors():
    ds = _DeviceClips()
    (batch,) = list(pds.train_batches(ds, 3, seed=0))
    assert isinstance(batch["x"], torch.Tensor) and batch["x"].shape == (3, 2, 4, 4, 21)
    assert batch["x"][:, 0, 0, 0, 0].tolist() == batch["label"].tolist()
    gen, spv = pds.eval_batches(ds, 4)
    batches = list(gen)
    assert spv == [2, 2, 2] and [b["valid"].tolist() for b in batches] == [
        [True] * 4, [True, True, False, False]]
    assert isinstance(batches[1]["x"], torch.Tensor)
    assert batches[1]["x"][:, 0, 0, 0, 0].tolist() == [2, 2, 2, 2]


def test_labels_round_trip(tmp_path):
    _, cfg = _cfgs(root=tmp_path)
    entries = [("train/001/M_00001.avi", "train/001/K_00001.avi", 1),
               ("train/002/M_00002.avi", "train/002/K_00002.avi", 249)]
    path = write_labels(cfg, "train", entries)
    assert path == tmp_path / "1_Sample" / "train.txt"
    assert get_labels(cfg, "train") == entries
    with pytest.raises(ValueError):
        get_labels(cfg, "val")


def _numbered(n, fail_at=None):
    for i in range(n):
        if i == fail_at:
            raise KeyError(f"batch {i}")
        yield {"x": np.full((2, 3), i, np.uint8), "label": np.asarray([i, i], np.int32),
               "valid": np.ones(2, bool)}


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_prefetch_keeps_order_and_converts(depth):
    got = list(prefetch_to_device(_numbered(7), "cpu", depth))
    assert [int(b["x"][0, 0]) for b in got] == list(range(7))
    for b in got:
        assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu" for v in b.values())
        assert b["x"].dtype == torch.uint8 and b["label"].dtype == torch.int32


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_prefetch_propagates_producer_errors(depth):
    seen = []
    with pytest.raises(KeyError, match="batch 3"):
        for b in prefetch_to_device(_numbered(7, fail_at=3), "cpu", depth):
            seen.append(int(b["x"][0, 0]))
    assert seen == [0, 1, 2]


def test_prefetch_stops_its_thread_when_the_consumer_stops():
    feed = prefetch_to_device(_numbered(100), "cpu", 2)
    assert int(next(feed)["x"][0, 0]) == 0
    feed.close()
    alive = [t for t in threading.enumerate() if t.name == "prefetch_to_device"]
    assert not alive


def test_native_backend_is_not_ported(monkeypatch, tmp_path):
    """Where the loader cannot be built, 'native' raises (it once raised
    always, before the loader was ported)."""
    from video_classification_tpu_torch.native import loader

    monkeypatch.setattr(loader, "get_lib", lambda: None)
    _, cfg = _cfgs(root=tmp_path, synthetic=0)
    write_labels(cfg, "train", [])
    cfg.DATA.BACKEND = "native"
    with pytest.raises(RuntimeError, match="native loader is unavailable"):
        pds.ChalearnVideoDataset(cfg, "train")
