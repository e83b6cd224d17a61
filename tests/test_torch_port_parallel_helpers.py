"""The port's data-parallel helpers (parallel/mesh.py, parallel/multihost.py,
the host-sharded feeding of data/dataset.py) against the JAX package's (CPU):

  * ``pad_batch_for_mesh`` over a grid of batch sizes and world sizes equal
    to JAX's on a mesh of that many of the eight virtual devices (numpy and
    tensors alike), and ``pad_to_multiple``;
  * ``host_batch_indices`` over a grid of (n, global batch, processes),
    with and without ``drop_last``, including the remainder tiling of
    tests/test_multihost.py:80;
  * ``train_batches_for_host``: every rank's rows equal JAX's, and
    concatenated equal the single-process global batch;
  * ``sharded_eval_plan`` and ``eval_batches_for_host`` equal JAX's;
  * ``initialize_distributed`` is a no-op without the environment and
    ``process_count``/``process_index`` are then 1 and 0.
"""

import numpy as np
import pytest
import torch

from video_classification_tpu.config import get_cfg as jax_get_cfg
from video_classification_tpu.data import dataset as jds
from video_classification_tpu.parallel import make_mesh
from video_classification_tpu.parallel import mesh as jmesh
from video_classification_tpu.parallel import multihost as jmultihost
from video_classification_tpu_torch.config import get_cfg
from video_classification_tpu_torch.data import dataset as pds
from video_classification_tpu_torch.parallel import mesh, multihost
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)


def _datasets(n_videos=11, seq_len=9, name_of_set="test"):
    out = []
    for c in (jax_get_cfg(), get_cfg()):
        c.CHALEARN.NUM_CLASS = 3
        c.CHALEARN.CLIP_LEN = 4
        c.MODEL.R3D_INPUT = "CropLHand"
        c.DATA.SYNTHETIC_NUM_VIDEOS = n_videos
        c.DATA.SYNTHETIC_SEQ_LEN = seq_len
        out.append(c)
    return (jds.ChalearnVideoDataset(out[0], name_of_set),
            pds.ChalearnVideoDataset(out[1], name_of_set))


@pytest.mark.parametrize("size", [1, 2, 3, 8])
@pytest.mark.parametrize("n", [1, 5, 8, 9])
def test_pad_batch_for_mesh_equals_jax(devices, n, size):
    batch = {"x": np.arange(n * 6, dtype=np.float32).reshape(n, 2, 3),
             "label": np.arange(n, dtype=np.int32)}
    want, want_n = jmesh.pad_batch_for_mesh(batch, make_mesh(devices=devices[:size]))
    got, got_n = mesh.pad_batch_for_mesh(batch, size)
    assert got_n == want_n == n and set(got) == set(want)
    for k in batch:
        np.testing.assert_array_equal(got[k], want[k])
    tensors, _ = mesh.pad_batch_for_mesh({k: torch.from_numpy(v) for k, v in batch.items()},
                                         size)
    for k in batch:
        assert isinstance(tensors[k], torch.Tensor)
        np.testing.assert_array_equal(tensors[k].numpy(), want[k])
    assert mesh.pad_to_multiple(n, size) == jmesh.pad_to_multiple(n, size)


@pytest.mark.parametrize("n", [0, 3, 8, 19, 20, 33])
@pytest.mark.parametrize("global_batch,processes", [(8, 1), (8, 2), (8, 4), (6, 3), (4, 4)])
@pytest.mark.parametrize("drop_last", [True, False])
def test_host_batch_indices_equal_jax(n, global_batch, processes, drop_last):
    order = list(np.random.RandomState(n).permutation(n))
    for index in range(processes):
        got = multihost.host_batch_indices(order, global_batch, processes, index, drop_last)
        want = jmultihost.host_batch_indices(order, global_batch, processes, index,
                                             drop_last)
        assert got == want
    if not drop_last and n:
        blocks = [multihost.host_batch_indices(order, global_batch, processes, i, False)
                  for i in range(processes)]
        assert all(len(b[-1]) == global_batch // processes for b in blocks)
    with pytest.raises(ValueError):
        multihost.host_batch_indices(order, global_batch, global_batch + 1, 0)


def test_remainder_tiles_up_to_a_full_batch():
    """tests/test_multihost.py:80: a last block of 3 rows, global batch 8."""
    b0 = multihost.host_batch_indices(list(range(19)), 8, 2, 0, drop_last=False)
    b1 = multihost.host_batch_indices(list(range(19)), 8, 2, 1, drop_last=False)
    assert [len(b) for b in b0] == [len(b) for b in b1] == [4, 4, 4]
    assert b0[-1] + b1[-1] == [16, 17, 18, 16, 17, 18, 16, 17]


@pytest.mark.parametrize("processes", [1, 2, 4])
def test_train_batches_for_host_equal_jax(processes):
    j, p = _datasets(n_videos=20, seq_len=6, name_of_set="train")
    full = list(pds.train_batches_for_host(p, 8, seed=3, n_processes=1, index=0))
    assert len(full) == 2
    ranks = []
    for i in range(processes):
        got = list(pds.train_batches_for_host(p, 8, seed=3, n_processes=processes, index=i))
        want = list(jds.train_batches_for_host(j, 8, seed=3, n_processes=processes, index=i))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g["x"].shape[0] == 8 // processes
            np.testing.assert_array_equal(g["x"], w["x"])
            np.testing.assert_array_equal(g["label"], w["label"])
        ranks.append(got)
    for step, f in enumerate(full):
        np.testing.assert_array_equal(f["x"], np.concatenate([r[step]["x"] for r in ranks]))
        np.testing.assert_array_equal(f["label"],
                                      np.concatenate([r[step]["label"] for r in ranks]))


@pytest.mark.parametrize("n_videos,global_batch,processes",
                         [(11, 8, 2), (11, 6, 3), (3, 8, 4), (7, 4, 1)])
def test_sharded_eval_equals_jax(n_videos, global_batch, processes):
    j, p = _datasets(n_videos=n_videos)
    got, want = (pds.sharded_eval_plan(p, global_batch, processes),
                 jds.sharded_eval_plan(j, global_batch, processes))
    assert (got.n_processes, got.local_batch, got.n_steps, got.samples_per_video) == (
        want.n_processes, want.local_batch, want.n_steps, want.samples_per_video)
    np.testing.assert_array_equal(got.labels, want.labels)
    for a, b in zip(got.positions, want.positions):
        np.testing.assert_array_equal(a, b)
    for index in range(processes):
        mine = list(pds.eval_batches_for_host(p, got, index, seed=1))
        theirs = list(jds.eval_batches_for_host(j, want, index, seed=1))
        assert len(mine) == len(theirs) == got.n_steps
        for a, b in zip(mine, theirs):
            assert set(a) == set(b)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
    assert p.sample_shape() == j.sample_shape()


def test_initialize_distributed_is_a_no_op_without_the_environment(monkeypatch):
    for k in multihost.ENV:
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize_distributed() is False
    assert multihost.initialize_distributed(device="cpu") is False  # twice: still a no-op
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    monkeypatch.setenv("RANK", "0")  # a partial environment is no cluster either
    assert multihost.initialize_distributed() is False
