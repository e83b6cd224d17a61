"""The port reads the checkpoints the JAX package writes (CPU, float32).

  * JAX ``save_checkpoint`` (flax msgpack) of slowfast (depth 18), res3d,
    res2d and the v2 (5, 2)-pathway model on numpy-seeded weights, then the
    port's ``load_checkpoint`` at the same root: through tier 1, and for a
    slowfast part stream through tier 2 (the HTAH file); eval logits within
    5e-3 of JAX ``apply`` on the same uint8 clips;
  * a root holding files of both packages: the highest accuracy wins,
    whichever package wrote it;
  * a flax file is loaded strictly (an extra or missing key raises and
    names it), an orbax directory raises naming the msgpack backend, and
    bytes of neither format raise;
  * the fusion: a JAX ``SparseTrainer.save_ckpt`` file read by the port's
    ``EnsemblePredictor``, its probabilities within 1e-6 of the JAX
    ``EnsemblePredictor`` on the same stream scores;
  * the converters: ``flax_to_torch`` and ``torch_to_flax`` equal to the
    JAX package's on slowfast and res2d, and ``torch_to_flax`` the inverse
    of ``flax_to_torch`` for every model (res3d, v2 and SparseModel too).
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from video_classification_tpu.config import load_model_cfg as jax_load_cfg
from video_classification_tpu.engine import EnsemblePredictor as JaxEnsemble
from video_classification_tpu.engine import SparseTrainer as JaxSparseTrainer
from video_classification_tpu.engine.checkpoint import save_checkpoint as jax_save
from video_classification_tpu.engine.model_manager import ModelManager as JaxMM
from video_classification_tpu.models import SparseModel as JaxSparseModel
from video_classification_tpu.models.torch_convert import flax_to_torch as jax_flax_to_torch
from video_classification_tpu.models.torch_convert import torch_to_flax as jax_torch_to_flax
from video_classification_tpu.v2.trainer import V2ModelManager as JaxV2MM
from video_classification_tpu_torch.config import load_model_cfg
from video_classification_tpu_torch.engine import (EnsemblePredictor, ModelManager,
                                                   ckpt_dir, load_checkpoint,
                                                   save_checkpoint)
from video_classification_tpu_torch.engine.checkpoint import read_state_dict
from video_classification_tpu_torch.engine.sparse import PART_YAMLS
from video_classification_tpu_torch.models import (SparseModel, flax_to_torch,
                                                   state_dict_from_jax, torch_to_flax)
from video_classification_tpu_torch.v2.trainer import V2ModelManager
from torch_port_support import one_torch_thread, randomised_variables  # noqa: F401

N, T = 2, 4
# Model name -> (yaml, spatial size, channels of the uint8 clip).
MODELS = {"slowfast": ("slowfast-HTAH", 32, 21), "res3d": ("res3d", 32, 21),
          "res2d": ("res2d", 64, 21), "v2": ("slowfast-HTAH", 32, 7)}


def _cfgs(root, model):
    yaml = MODELS[model][0]
    common = ["CHALEARN.ROOT", str(root), "MODEL.DEPTH", "18", "CHALEARN.NUM_CLASS", "5",
              "CHALEARN.CLIP_LEN", str(T)]
    if model == "v2":
        common += ["MODEL.INPUT_SIZE", str(MODELS[model][1])]
    jcfg = jax_load_cfg(yaml, common + ["TPU.COMPUTE_DTYPE", "float32"])
    cfg = load_model_cfg(yaml, common + ["CUDA.COMPUTE_DTYPE", "float32"])
    return jcfg, cfg


def _port_manager(cfg, model):
    if model == "v2":
        return V2ModelManager(cfg, device="cpu")
    return ModelManager(cfg, torch.device("cpu"))


def _jax_side(jcfg, model, seed):
    """The JAX model, its seeded variables and a uint8 clip batch."""
    jmm = JaxV2MM(jcfg) if model == "v2" else JaxMM(jcfg)
    jmodel = jmm.init_model()
    _, size, channels = MODELS[model]
    x = np.random.RandomState(seed).randint(0, 256, (N, T, size, size, channels))
    x = x.astype(np.uint8)
    inputs = jmm.normalize_and_prepare(jnp.asarray(x))
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False),
                            jax.random.PRNGKey(0), inputs)
    variables = randomised_variables(shapes, seed)
    logits = np.asarray(jmodel.apply(variables, inputs, train=False))
    return variables, x, logits


def _port_logits(mm, model, x):
    with torch.no_grad():
        return model(mm.normalize_and_prepare(torch.from_numpy(x))).numpy()


@pytest.mark.parametrize("model,tier", [("slowfast", 1), ("slowfast", 2), ("res3d", 1),
                                        ("res2d", 1), ("v2", 1)])
def test_load_checkpoint_reads_jax_files(tmp_path, model, tier):
    jcfg, cfg = _cfgs(tmp_path, model)
    variables, x, want = _jax_side(jcfg, model, seed=len(model) + tier)
    if tier == 2:  # the HTAH stream's file, restored into a part stream
        for c in (jcfg, cfg):
            c.MODEL.NAME, c.MODEL.R3D_INPUT = "slowfast-HTAH", "CropHTAH"
        path = jax_save(jcfg, variables, epoch=3, acc=0.5)
        cfg.MODEL.NAME, cfg.MODEL.R3D_INPUT = "slowfast-LHand", "CropLHand"
    else:
        path = jax_save(jcfg, variables, epoch=3, acc=0.5)
    assert path.parent == ckpt_dir(cfg).parent / jcfg.MODEL.NAME
    assert path.read_bytes()[:1] != b"P"  # flax msgpack, not a torch zip
    mm = _port_manager(cfg, model)
    port = mm.init_model()
    assert load_checkpoint(cfg, port) == path
    got = _port_logits(mm, port, x)
    assert got.shape == want.shape == (N, 5) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=5e-3)


def test_mixed_root_takes_the_highest_accuracy(tmp_path):
    jcfg, cfg = _cfgs(tmp_path, "slowfast")
    variables, x, want = _jax_side(jcfg, "slowfast", seed=7)
    mm = ModelManager(cfg, torch.device("cpu"))
    own = mm.init_model()
    save_checkpoint(cfg, own, epoch=1, acc=0.4)
    jax_path = jax_save(jcfg, variables, epoch=2, acc=0.6)
    model = mm.init_model()
    assert load_checkpoint(cfg, model) == jax_path
    np.testing.assert_allclose(_port_logits(mm, model, x), want, atol=5e-3, rtol=5e-3)
    best = save_checkpoint(cfg, own, epoch=3, acc=0.8)
    assert load_checkpoint(cfg, model) == best
    for k, v in own.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_flax_files_load_strictly(tmp_path):
    jcfg, cfg = _cfgs(tmp_path, "slowfast")
    variables, _, _ = _jax_side(jcfg, "slowfast", seed=8)
    model = ModelManager(cfg, torch.device("cpu")).init_model()
    extra = jax.tree.map(lambda a: a, variables)
    extra["params"]["blocks_1_pathway_0"]["mystery"] = {"kernel": np.zeros((1, 1))}
    path = jax_save(jcfg, extra, epoch=1, acc=0.5)
    with pytest.raises(KeyError, match="blocks_1_pathway_0/mystery"):
        load_checkpoint(cfg, model)
    path.unlink()
    missing = jax.tree.map(lambda a: a, variables)
    del missing["batch_stats"]["blocks_0_pathway_1"]["norm"]["var"]
    jax_save(jcfg, missing, epoch=1, acc=0.5)
    with pytest.raises(RuntimeError, match="blocks.0.multipathway_blocks.1.norm.running_var"):
        load_checkpoint(cfg, model)


def test_orbax_directories_and_foreign_files_are_refused(tmp_path):
    jcfg, cfg = _cfgs(tmp_path, "slowfast")
    variables, _, _ = _jax_side(jcfg, "slowfast", seed=9)
    path = jax_save(jcfg, variables, epoch=1, acc=0.5, backend="orbax")
    assert path.is_dir()
    model = ModelManager(cfg, torch.device("cpu")).init_model()
    with pytest.raises(ValueError, match="orbax.*msgpack"):
        load_checkpoint(cfg, model)
    foreign = tmp_path / "foreign.ckpt"
    foreign.write_bytes(b"\x00\x01\x02\x03")
    with pytest.raises(ValueError, match="neither"):
        read_state_dict(foreign)


class _Stream:
    def __init__(self, scores):
        self.scores = scores

    def clip_scores(self, m_path, k_path=None):
        return self.scores


def test_ensemble_reads_the_jax_fusion_checkpoint(tmp_path):
    """The JAX SparseTrainer's save_ckpt file at the fusion's default path,
    read by both packages' EnsemblePredictor over the same stream scores."""
    classes, parts = 249, len(PART_YAMLS)
    jcfg, cfg = _cfgs(tmp_path, "slowfast")
    rng = np.random.RandomState(10)
    params = {"weight": rng.normal(1.0, 0.5, (classes, parts)).astype(np.float32),
              "bias": rng.normal(0.0, 0.2, (classes,)).astype(np.float32)}
    folder = tmp_path / "logs" / "sparse_fusion_ckpt"
    JaxSparseTrainer.save_ckpt(SimpleNamespace(ckpt_folder=folder, params=params), 0.5, 4)
    scores = [np.asarray(jax.nn.softmax(jnp.asarray(rng.normal(0, 3, (3, classes)))),
                         np.float32) for _ in PART_YAMLS]

    jens = JaxEnsemble.__new__(JaxEnsemble)
    jens.cfg, jens.part_yamls = jcfg, list(PART_YAMLS)
    jens.predictors = [_Stream(s) for s in scores]
    jens._fusion_params, jens._fusion_model = None, None
    want = jens.predict("m.avi")

    ens = EnsemblePredictor.__new__(EnsemblePredictor)
    ens.device, ens.cfg, ens.part_yamls = torch.device("cpu"), cfg, list(PART_YAMLS)
    ens.predictors = [_Stream(s) for s in scores]
    ens._fusion_params, ens.fusion, ens.fusion_source = None, None, None
    got = ens.predict("m.avi")
    assert ens.fusion_source == str(folder / "acc-0.500-epoch-4")
    assert torch.equal(ens.fusion.weight, torch.from_numpy(params["weight"]))
    np.testing.assert_allclose(got["probs"], want["probs"], atol=1e-6, rtol=0)
    assert got["top"][0][0] == want["top"][0][0]


def _variables(model, seed):
    if model == "sparse":
        jm = JaxSparseModel(7, 5)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 5, 7)))
        rng = np.random.RandomState(seed)
        return {"params": {k: rng.normal(0, 1, v.shape).astype(np.float32)
                           for k, v in shapes["params"].items()}, "batch_stats": {}}
    jcfg, _ = _cfgs("/unused", model)
    return _jax_side(jcfg, model, seed)[0]


def _assert_trees_equal(got, want, path=""):
    assert isinstance(got, dict) and sorted(got) == sorted(want), (path, sorted(got))
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                          err_msg=f"{path}/{k}")


@pytest.mark.parametrize("model", ["slowfast", "res3d", "res2d", "v2", "sparse"])
def test_converters_match_jax_and_invert(model):
    variables = _variables(model, seed=11)
    sd = flax_to_torch(variables, arch=model if model != "v2" else "slowfast")
    assert sd.keys() == state_dict_from_jax(variables).keys()
    _assert_trees_equal(torch_to_flax(sd, arch="slowfast"), variables)
    if model in ("slowfast", "res2d"):  # the grammars the JAX package converts
        want = jax_flax_to_torch(variables, arch=model)
        assert sd.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
        numpy_sd = {k: v.numpy() for k, v in sd.items()}
        _assert_trees_equal(torch_to_flax(sd, arch=model),
                            jax_torch_to_flax(numpy_sd, arch=model))


def test_converters_refuse_unknown_names():
    with pytest.raises(KeyError, match="blocks.9.mystery"):
        torch_to_flax({"blocks.9.mystery.weight": torch.zeros(3)})
    with pytest.raises(ValueError, match="arch"):
        torch_to_flax({}, arch="vit")
    with pytest.raises(ValueError, match="arch"):
        flax_to_torch({}, arch="vit")
    sparse = SparseModel(7, 5)
    tree = torch_to_flax(sparse.state_dict(), arch="sparse")
    assert tree == {"params": {"weight": tree["params"]["weight"],
                               "bias": tree["params"]["bias"]}, "batch_stats": {}}
    assert serialization.msgpack_restore(serialization.to_bytes(tree["params"])).keys() == \
        {"weight", "bias"}
