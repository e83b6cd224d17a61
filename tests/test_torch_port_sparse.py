"""The sparse-fusion slice of the PyTorch port against the JAX package (CPU).

  * ``SparseModel`` on carried parameters within 1e-6 of flax's
    ``SparseModel.apply``; its initial weight is flax's ``lecun_normal`` on
    the (C, P) array, whose fan_in is C: over 8 seeded inits of each, the
    standard deviations agree within 5 % (and with 1/sqrt(C)), every |w| is
    within the truncation 2 sigma / 0.8796, and the bias starts at zero;
  * ``epoch_batch_plan`` equal to the JAX package's, and one port epoch
    touches every sample exactly once;
  * the materials: the JAX package's ``ResultSaver`` writes pickles that the
    port's ``SparseFusionDataset`` stacks exactly as the JAX one does, and
    the port's ``ResultSaver`` (its real ``Trainer``, depth 18) writes
    pickles that the JAX package reads and trains on;
  * ``SparseTrainer``: from the JAX trainer's initial parameters and with
    the JAX trainer's own per-epoch permutations (jax.random.permutation of
    each epoch key, injected: randomness cannot cross frameworks), 5 epochs
    give parameters within 1e-5 and equal epoch losses and ``test()``
    accuracy;
  * the best-accuracy checkpoint's name and round trip, and the fusion of
    ``EnsemblePredictor``: lexicographically last checkpoint loaded, all-ones
    weight and bias (uniform mixing) without one, and the fused output
    (streams sorted by name, clips cut to the fewest, softmax after the mean
    of the fused logits) equal to JAX's on the same per-stream scores.
"""

import pickle
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_classification_tpu.config import get_cfg as jax_get_cfg
from video_classification_tpu.engine import sparse as jax_sparse
from video_classification_tpu.engine.predictor import EnsemblePredictor as JaxEnsemble
from video_classification_tpu.models.sparse_fusion import SparseModel as JaxSparseModel
from video_classification_tpu_torch.config import get_cfg
from video_classification_tpu_torch.engine import (EnsemblePredictor, ResultSaver,
                                                   SparseFusionDataset, SparseTrainer)
from video_classification_tpu_torch.engine import sparse
from video_classification_tpu_torch.models import SparseModel, state_dict_from_jax
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)


def _cfg(get, root):
    c = get()
    c.CHALEARN.ROOT = str(root)
    return c


def make_materials(root, num_parts=3, num_videos=25, clips_per_video=2, num_class=5,
                   seed=0):
    """Per-part eval pickles with a learnable structure (part 0 carries the
    label, the others are noise), written for both sets under ``root``."""
    rng = np.random.RandomState(seed)
    n = num_videos * clips_per_video
    for name_of_set in ("train", "test"):
        t = np.repeat(rng.randint(0, num_class, num_videos), clips_per_video).astype(np.int32)
        for part in range(num_parts):
            logits = rng.randn(n, num_class).astype(np.float32)
            if part == 0:
                logits[np.arange(n), t] += 2.0
            ps = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
            d = sparse.sparse_dir(_cfg(get_cfg, root), name_of_set)
            d.mkdir(parents=True, exist_ok=True)
            with (d / f"slowfast-part{part}").open("wb") as f:
                pickle.dump({"ps": ps.astype(np.float32), "t": t, "acc": 0.0,
                             "sv": [clips_per_video] * num_videos}, f)


@pytest.mark.parametrize("num_class,num_part", [(7, 3), (249, 5)])
def test_sparse_model_matches_flax(num_class, num_part):
    rng = np.random.RandomState(num_class)
    params = {"weight": rng.normal(size=(num_class, num_part)).astype(np.float32),
              "bias": rng.normal(size=(num_class,)).astype(np.float32)}
    x = rng.rand(11, num_part, num_class).astype(np.float32)
    want = np.asarray(JaxSparseModel(num_class, num_part).apply(
        {"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(x)))
    model = SparseModel(num_class, num_part)
    model.load_state_dict(state_dict_from_jax({"params": params}))
    got = model(torch.from_numpy(x)).detach().numpy()
    assert got.dtype == np.float32 and got.shape == (11, num_class)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        model(torch.from_numpy(x[:, :, :-1]))


@pytest.mark.parametrize("num_class,num_part", [(249, 5), (20, 64)])
def test_init_is_flax_lecun_normal_with_fan_in_c(num_class, num_part):
    flax_w = np.stack([np.asarray(JaxSparseModel(num_class, num_part).init(
        jax.random.PRNGKey(s), jnp.zeros((1, num_part, num_class)))["params"]["weight"])
        for s in range(8)])
    models = [SparseModel(num_class, num_part, torch.Generator().manual_seed(s))
              for s in range(8)]
    port_w = np.stack([m.weight.detach().numpy() for m in models])
    sigma = 1.0 / np.sqrt(num_class)  # fan_in = C, not P
    assert abs(port_w.std() / flax_w.std() - 1.0) < 0.05, (port_w.std(), flax_w.std())
    assert abs(port_w.std() / sigma - 1.0) < 0.05
    assert np.abs(port_w).max() <= 2 * sigma / 0.8796 + 1e-7
    assert np.abs(flax_w).max() <= 2 * sigma / 0.8796 + 1e-7
    assert all(not m.bias.detach().any() for m in models)
    # Seeded: the same generator seed gives the same weight.
    again = SparseModel(num_class, num_part, torch.Generator().manual_seed(3))
    assert torch.equal(again.weight, models[3].weight)


@pytest.mark.parametrize("n,bs", [(20, 8), (8, 8), (5, 8), (16, 8), (1, 500), (35878, 500)])
def test_epoch_batch_plan_equals_jax(n, bs):
    assert sparse.epoch_batch_plan(n, bs) == jax_sparse.epoch_batch_plan(n, bs)


def test_constants_equal_jax():
    assert sparse.PART_YAMLS == jax_sparse.PART_YAMLS
    assert (sparse.SPARSE_BATCH, sparse.SPARSE_LR, sparse.SPARSE_EPOCHS, sparse.TEST_EVERY) == (
        jax_sparse.SPARSE_BATCH, jax_sparse.SPARSE_LR, jax_sparse.SPARSE_EPOCHS,
        jax_sparse.TEST_EVERY)


def test_an_epoch_uses_every_sample_once(tmp_path):
    make_materials(tmp_path, num_videos=10, clips_per_video=2)
    st = SparseTrainer(_cfg(get_cfg, tmp_path), batch_size=8, device="cpu")
    seen = []
    real = st.model.forward
    st.model.forward = lambda x: (seen.append(x.clone()), real(x))[1]
    perm = np.random.RandomState(0).permutation(20)
    st.train_epoch(perm)
    assert [x.shape[0] for x in seen] == [8, 8, 4]
    np.testing.assert_array_equal(torch.cat(seen).numpy(), st.x_train[perm].numpy())
    with pytest.raises(ValueError):
        st.train_epoch(perm[:-1])


class _ScoresTrainer:
    """A trainer stub for the JAX ResultSaver: run_eval scores each clip by
    a fixed projection of its mean pixel values, so the pickles carry real
    data through the saver's own datasets and batching."""

    def __init__(self, cfg):
        self.num_class = int(cfg.CHALEARN.NUM_CLASS)

    def run_eval(self, batches, samples_per_video):
        ps, t = [], []
        for b in batches:
            m = np.asarray(b["x"], np.float32).mean(axis=(1, 2, 3))  # (N, 21)
            logits = m[:, :self.num_class] / 40.0
            p = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
            ps.append(p[b["valid"]])
            t.append(np.asarray(b["label"])[b["valid"]])
        return {"ps": np.concatenate(ps).astype(np.float32), "t": np.concatenate(t),
                "acc": 0.5, "sv": list(samples_per_video)}


def _stream_overrides(root, pkg):
    dtype = "TPU.COMPUTE_DTYPE" if pkg == "jax" else "CUDA.COMPUTE_DTYPE"
    return ["CHALEARN.ROOT", str(root), "CHALEARN.NUM_CLASS", "3", "CHALEARN.CLIP_LEN", "4",
            "CHALEARN.BATCH_SIZE", "6", "MODEL.DEPTH", "18", dtype, "float32",
            "DATA.SYNTHETIC_NUM_VIDEOS", "4", "DATA.SYNTHETIC_SEQ_LEN", "10"]


def test_jax_written_materials_read_by_the_port(tmp_path):
    parts = ["slowfast-LHand", "slowfast-RHand"]
    jax_sparse.ResultSaver(parts, _stream_overrides(tmp_path, "jax"),
                           trainer_factory=_ScoresTrainer).save_network_output()
    for name_of_set in ("train", "test"):
        folder = sparse.sparse_dir(_cfg(get_cfg, tmp_path), name_of_set)
        assert sorted(p.name for p in folder.iterdir()) == parts
        got, want = SparseFusionDataset(folder), jax_sparse.SparseFusionDataset(folder)
        assert got.part_names == want.part_names == parts
        np.testing.assert_array_equal(got.PS, want.PS)
        np.testing.assert_array_equal(got.T, want.T)
        np.testing.assert_array_equal(got.sv, want.sv)
        assert got.PS.shape == (2, 8, 3) and list(got.sv) == [2, 2, 2, 2]
        for a, b in zip(got.as_arrays(), want.as_arrays()):
            np.testing.assert_array_equal(a, b)


def test_port_written_materials_read_by_jax(tmp_path):
    parts = ["slowfast-LHand", "slowfast-RHand"]
    written = ResultSaver(parts, _stream_overrides(tmp_path, "port"),
                          device="cpu").save_network_output()
    assert [p.name for p in written] == [p for p in parts for _ in range(2)]
    jcfg = _cfg(jax_get_cfg, tmp_path)
    for name_of_set in ("train", "test"):
        folder = sparse.sparse_dir(jcfg, name_of_set)
        for path in folder.iterdir():
            with path.open("rb") as f:
                y = pickle.load(f)
            assert set(y) == {"ps", "t", "acc", "sv"}
            assert type(y["ps"]) is np.ndarray and y["ps"].dtype == np.float32
            assert type(y["t"]) is np.ndarray and type(y["acc"]) is float
            assert y["sv"] == [2, 2, 2, 2]
            np.testing.assert_allclose(y["ps"].sum(1), 1.0, atol=1e-5)
        want, got = jax_sparse.SparseFusionDataset(folder), SparseFusionDataset(folder)
        np.testing.assert_array_equal(got.PS, want.PS)
        assert want.PS.shape == (2, 8, 3)
    jt = jax_sparse.SparseTrainer(jcfg, batch_size=4)
    assert 0.0 <= jt.train(epochs=10) <= 1.0


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The JAX SparseTrainer's first 5 epochs, with its permutations."""
    base = tmp_path_factory.mktemp("sparse_parity")
    make_materials(base / "jax")
    shutil.copytree(base / "jax", base / "port")
    jt = jax_sparse.SparseTrainer(_cfg(jax_get_cfg, base / "jax"), batch_size=8)
    init = jax.device_get(jt.params)
    rng = jax.random.PRNGKey(1)  # as SparseTrainer.train splits it
    perms, losses = [], []
    for _ in range(5):
        rng, e_rng = jax.random.split(rng)
        perms.append(np.asarray(jax.random.permutation(e_rng, jt.train_dataset.num_n)))
        jt.params, jt.opt_state, loss = jt._epoch_fn(jt.params, jt.opt_state, e_rng)
        losses.append(float(loss))
    return {"base": base, "jt": jt, "init": init, "perms": perms, "losses": losses}


def test_sparse_trainer_matches_jax(trained):
    pt = SparseTrainer(_cfg(get_cfg, trained["base"] / "port"), batch_size=8, device="cpu")
    pt.model.load_state_dict(state_dict_from_jax({"params": trained["init"]}))
    losses = [float(pt.train_epoch(p)) for p in trained["perms"]]
    np.testing.assert_allclose(losses, trained["losses"], rtol=1e-5)
    want = state_dict_from_jax({"params": jax.device_get(trained["jt"].params)})
    got = pt.model.state_dict()
    assert set(got) == set(want) == {"weight", "bias"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-5, rtol=0)
    # Equal video counts (the float32 means may round apart in the last bit).
    videos = len(pt.test_dataset.sv)
    assert round(pt.test(epoch=4) * videos) == round(trained["jt"].test(epoch=4) * videos)


def test_best_checkpoint_name_and_round_trip(tmp_path):
    make_materials(tmp_path)
    cfg = _cfg(get_cfg, tmp_path)
    st = SparseTrainer(cfg, batch_size=8, device="cpu")
    best = st.train(epochs=20)  # tests at epochs 9 and 19
    files = sorted(p.name for p in st.ckpt_folder.iterdir())
    assert files and st.ckpt_folder == Path(tmp_path, "logs", "sparse_fusion_ckpt")
    assert files[-1] == "acc-%.3f-epoch-%d" % (best, int(files[-1].rsplit("-", 1)[1]))
    assert all(f.startswith("acc-") and "-epoch-" in f for f in files)
    saved = torch.load(st.ckpt_folder / files[-1], weights_only=True)
    if files[-1].endswith("-epoch-19"):  # the last test was the best: the current weights
        for k, v in st.model.state_dict().items():
            assert torch.equal(saved[k], v)
    ens = EnsemblePredictor(["slowfast-LHand"], ["CHALEARN.ROOT", str(tmp_path),
                                                 "MODEL.DEPTH", "18"], device="cpu")
    ens._load_fusion(3, 5)
    assert ens.fusion_source == str(st.ckpt_folder / files[-1])
    for k, v in ens.fusion.state_dict().items():
        assert torch.equal(v, saved[k])


def _named_scores(seed, names=("slowfast-RHand", "slowfast-HTAH", "slowfast-LHand"),
                  clips=(3, 2, 4), num_class=6):
    rng = np.random.RandomState(seed)
    out = {}
    for name, n in zip(names, clips):
        ps = rng.rand(n, num_class).astype(np.float32)
        out[name] = ps / ps.sum(1, keepdims=True)
    return out


class _FixedScores:
    def __init__(self, ps):
        self.ps = ps

    def clip_scores(self, m_path, k_path=None):
        return self.ps

    clip_scores_frames = clip_scores


@pytest.mark.parametrize("fusion", ["uniform", "given"])
def test_ensemble_fusion_matches_jax(tmp_path, fusion):
    """The fusion step alone: both packages' EnsemblePredictor on the same
    per-stream clip scores (stream predictors replaced by fixed scores)."""
    scores = _named_scores(1)
    names = list(scores)
    rng = np.random.RandomState(2)
    params = {"weight": rng.normal(size=(6, 3)).astype(np.float32),
              "bias": rng.normal(size=(6,)).astype(np.float32)}
    jens = object.__new__(JaxEnsemble)
    jens.part_yamls, jens.cfg = names, _cfg(jax_get_cfg, tmp_path)
    jens.predictors = [_FixedScores(scores[n]) for n in names]
    jens._fusion_params = (None if fusion == "uniform"
                           else jax.tree.map(jnp.asarray, params))
    jens._fusion_model = None
    want = jens.predict("m.avi", None, top_k=4)

    ens = object.__new__(EnsemblePredictor)
    ens.part_yamls, ens.cfg, ens.device = names, _cfg(get_cfg, tmp_path), torch.device("cpu")
    ens.predictors = [_FixedScores(scores[n]) for n in names]
    ens._fusion_params = None if fusion == "uniform" else params
    ens.fusion = ens.fusion_source = None
    for got in (ens.predict("m.avi", None, top_k=4), ens.predict_frames(None, None, top_k=4)):
        assert ens.fusion_source == fusion
        assert got["clips"] == want["clips"] == 2
        np.testing.assert_allclose(got["probs"], want["probs"], atol=1e-6)
        assert [c for c, _ in got["top"]] == [c for c, _ in want["top"]]
        np.testing.assert_allclose([p for _, p in got["top"]], [p for _, p in want["top"]],
                                   atol=1e-6)
        assert got["per_stream"] == pytest.approx(want["per_stream"], abs=1e-6)
        assert list(got["per_stream"]) == sorted(names)
    if fusion == "uniform":
        assert all(torch.equal(v, torch.ones_like(v))
                   for v in ens.fusion.state_dict().values())
