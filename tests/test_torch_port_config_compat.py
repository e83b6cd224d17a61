"""The port reads the JAX package's configuration (CPU).

  * ``TPU.*`` keys from an override list, a yaml file and
    ``cfg_override.yaml``: the six with a ``CUDA.*`` counterpart set it, the
    five TPU routes are ignored and named in one warning, a misspelt key
    still raises ``KeyError``;
  * the SKILL.md recipe's ``--opts ... TPU.COMPUTE_DTYPE float32`` through
    the port's CLI on a root the JAX package trained: ``eval`` restores the
    JAX checkpoint and ``train`` resumes from it;
  * ``get_override_cfg`` against the JAX package's on the same
    ``../cfg_override.yaml``;
  * ``to_dict``, ``dump`` and ``__str__``: the text round-trips through the
    port's loader and reads the same with ``yaml.safe_load``; the JAX
    package's own ``dump`` (block sequences) merges into the port's tree.
"""

import contextlib
import functools
import io
from pathlib import Path

import jax
import numpy as np
import pytest
import yaml

from video_classification_tpu.config import get_cfg as jax_get_cfg
from video_classification_tpu.config import get_override_cfg as jax_get_override_cfg
from video_classification_tpu.config import load_model_cfg as jax_load_cfg
from video_classification_tpu.engine.checkpoint import save_checkpoint as jax_save
from video_classification_tpu.engine.model_manager import ModelManager as JaxMM
from video_classification_tpu_torch import __main__ as cli
from video_classification_tpu_torch.config import (CfgNode, get_cfg, get_override_cfg,
                                                   load_model_cfg, load_yaml)
from video_classification_tpu_torch.config.node import TPU_ROUTES, TPU_TO_CUDA
from torch_port_support import one_torch_thread, randomised_variables  # noqa: F401

# .claude/skills/verify/SKILL.md step 3, with the port's synthetic clips in
# place of the preprocessed crop folders.
SKILL_OPTS = ["CHALEARN.NUM_CLASS", "2", "CHALEARN.CLIP_LEN", "2", "CHALEARN.BATCH_SIZE",
              "2", "MODEL.DEPTH", "18", "MODEL.MAX_EPOCH", "2", "TPU.COMPUTE_DTYPE",
              "float32"]
SYNTHETIC = ["DATA.SYNTHETIC_NUM_VIDEOS", "4", "DATA.SYNTHETIC_SEQ_LEN", "4"]
JAX_VALUES = {"COMPUTE_DTYPE": "float16", "PARAM_DTYPE": "bfloat16", "SEED": 3,
              "PREFETCH_DEPTH": 2, "REMAT": True, "REMAT_POLICY": "conv"}
ROUTE_VALUES = {"MESH_SHAPE": [2, 4], "MESH_AXES": ["data", "model"],
                "DONATE_STATE": False, "PACK_FAST": False,
                "COMPILATION_CACHE_DIR": "/tmp/xla_cache"}


def test_the_tables_cover_the_jax_tpu_namespace():
    assert sorted(TPU_TO_CUDA + TPU_ROUTES) == sorted(jax_get_cfg().TPU)
    assert set(TPU_TO_CUDA) == set(get_cfg().CUDA)


def test_tpu_keys_from_a_list(capsys):
    cfg = get_cfg()
    opts = []
    for k, v in {**JAX_VALUES, **ROUTE_VALUES}.items():
        opts += [f"TPU.{k}", str(v)]
    cfg.merge_from_list(opts + ["MODEL.DEPTH", "18"])
    assert cfg.CUDA == JAX_VALUES and cfg.MODEL.DEPTH == 18 and "TPU" not in cfg
    out = capsys.readouterr().out
    assert out.count("warning:") == 1
    assert all(f"TPU.{k}" in out for k in TPU_ROUTES)
    for bad in ("TPU.COMPUTE_DTYP", "TPU.MESH_SHAPE.X", "CUDA.COMPUTE_DTYP", "TPUS.SEED"):
        with pytest.raises(KeyError, match=bad.replace(".", r"\.")):
            get_cfg().merge_from_list([bad, "1"])


def test_tpu_keys_from_a_file(tmp_path, capsys):
    text = "TPU:\n" + "".join(f"  {k}: {v!r}\n" if isinstance(v, str) else
                              f"  {k}: {str(v).lower() if isinstance(v, bool) else v}\n"
                              for k, v in {**JAX_VALUES, **ROUTE_VALUES}.items())
    path = tmp_path / "jax.yaml"
    path.write_text(text + "MODEL:\n  DEPTH: 18\n")
    cfg = get_cfg()
    cfg.merge_from_file(path)
    assert cfg.CUDA == JAX_VALUES and cfg.MODEL.DEPTH == 18
    assert capsys.readouterr().out.count("warning:") == 1
    path.write_text("TPU:\n  PACK_FASTER: true\n")
    with pytest.raises(KeyError, match="TPU.PACK_FASTER"):
        get_cfg().merge_from_file(path)
    path.write_text("TPU:\n  SEED: 'zero'\n")
    with pytest.raises(ValueError, match="TPU.SEED"):
        get_cfg().merge_from_file(path)


def test_get_override_cfg_reads_the_file_the_jax_package_reads(tmp_path, monkeypatch):
    work = tmp_path / "checkout"
    work.mkdir()
    monkeypatch.chdir(work)
    assert get_override_cfg() == get_cfg()
    (tmp_path / "cfg_override.yaml").write_text(
        "CHALEARN:\n  ROOT: /data/iso\n  BATCH_SIZE: 4\nTPU:\n  COMPUTE_DTYPE: float32\n"
        "  MESH_SHAPE: [2, 4]\n")
    got, want = get_override_cfg(), jax_get_override_cfg()
    assert got.CHALEARN == want.CHALEARN and got.CHALEARN.ROOT == "/data/iso"
    assert got.CUDA.COMPUTE_DTYPE == want.TPU.COMPUTE_DTYPE == "float32"
    assert load_model_cfg("slowfast-HTAH").CUDA.COMPUTE_DTYPE == "float32"


@pytest.mark.parametrize("name", ["slowfast-HTAH", "res2d", "res3d"])
def test_dump_round_trips(name):
    cfg = load_model_cfg(name, ["MODEL.LR", "1e-06", "CHALEARN.ROOT", "it's: #here"])
    text = cfg.dump()
    assert str(cfg) == text
    assert load_yaml(text) == yaml.safe_load(text) == cfg.to_dict()
    back = get_cfg()
    back.merge_from_other_cfg(CfgNode(load_yaml(text)))
    assert back == cfg and back.MODEL.LR == 1e-06


def test_dump_of_every_scalar_form():
    node = CfgNode({"A": {"s": "yes", "e": "5e-4", "n": "null", "q": "'x'", "empty": "",
                          "i": -3, "f": 2.5e-10, "big": 1e300, "inf": float("inf"),
                          "ninf": float("-inf"), "t": True, "none": None,
                          "seq": [1, "two", 3.0, None]}})
    text = node.dump()
    assert load_yaml(text) == yaml.safe_load(text) == node.to_dict()
    with pytest.raises(ValueError, match="lists of scalars"):
        CfgNode({"A": [[1]]}).dump()


def test_the_jax_dump_merges_into_the_port(capsys):
    jcfg = jax_get_cfg()
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    jcfg.TPU.MESH_SHAPE = [2, 4]
    jcfg.MODEL.DEPTH = 18
    cfg = get_cfg()
    cfg.merge_from_other_cfg(CfgNode(load_yaml(jcfg.dump())))
    assert cfg.CUDA.COMPUTE_DTYPE == "float32" and cfg.MODEL.DEPTH == 18
    assert "TPU.MESH_SHAPE" in capsys.readouterr().out


def _run(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_skill_recipe_serves_and_resumes_a_jax_root(tmp_path, monkeypatch):
    """A root the JAX package trained (its slowfast-Torso checkpoint): the
    port's ``eval`` restores it, ``train`` resumes from it and saves its
    own, which ``eval`` then takes (the higher accuracy sorts last)."""
    opts = SKILL_OPTS + SYNTHETIC
    jcfg = jax_load_cfg("slowfast-Torso", ["CHALEARN.ROOT", str(tmp_path)] + SKILL_OPTS)
    assert load_model_cfg("slowfast-Torso", SKILL_OPTS).CUDA.COMPUTE_DTYPE == "float32"
    jmm = JaxMM(jcfg)
    x = np.zeros((1, 2, 32, 32, 21), np.uint8)
    shapes = jax.eval_shape(functools.partial(jmm.init_model().init, train=False),
                            jax.random.PRNGKey(0), jmm.normalize_and_prepare(x))
    jax_path = jax_save(jcfg, randomised_variables(shapes, 12), epoch=0, acc=0.0)
    monkeypatch.setenv("VCT_PLATFORM", "cpu")
    common = ["slowfast-Torso", "--root", str(tmp_path), "--opts"] + opts
    rc, out, err = _run(["eval"] + common)
    assert rc == 0, err
    assert f"loading checkpoint from {jax_path}" in out and "accuracy: " in out
    rc, out, err = _run(["train"] + common)
    assert rc == 0, err
    assert f"loading checkpoint from {jax_path}" in out and "[ckpt_saved]" in out
    saved = sorted(Path(jax_path).parent.glob("*.ckpt"))
    assert len(saved) >= 2 and saved[-1] != jax_path
    assert saved[-1].read_bytes()[:4] == b"PK\x03\x04"
    rc, out, _ = _run(["eval"] + common)
    assert rc == 0 and f"loading checkpoint from {saved[-1]}" in out
