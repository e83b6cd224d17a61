"""Config parity of the PyTorch port (CPU): the PyYAML-free loader reads the
8 model yamls exactly as ``yaml.safe_load`` does, and ``load_model_cfg``
agrees with the JAX package's on every shared key."""

from pathlib import Path

import pytest
import yaml

from video_classification_tpu.config import load_model_cfg as jax_load_model_cfg
from video_classification_tpu_torch.config import get_cfg, load_model_cfg, load_yaml
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)

PORT_YAMLS = Path(__file__).parent.parent / "video_classification_tpu_torch" / "config" / "yamls"
JAX_YAMLS = Path(__file__).parent.parent / "video_classification_tpu" / "config" / "yamls"
NAMES = sorted(p.stem for p in JAX_YAMLS.glob("*.yaml"))


def _flat(node, prefix=""):
    out = {}
    for k, v in node.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_all_eight_yamls_are_ported():
    assert len(NAMES) == 8
    assert sorted(p.stem for p in PORT_YAMLS.glob("*.yaml")) == NAMES
    for name in NAMES:
        assert (PORT_YAMLS / f"{name}.yaml").read_text() == \
            (JAX_YAMLS / f"{name}.yaml").read_text()


@pytest.mark.parametrize("name", NAMES)
def test_yaml_parser_equals_pyyaml(name):
    text = (PORT_YAMLS / f"{name}.yaml").read_text()
    assert load_yaml(text) == yaml.safe_load(text)


SCALARS = """\
A:
  LR: 5e-4
  F: 1.0e-3
  G: .5
  B1: yes
  B2: False
  N: ~
  E:
  S: 'it''s # not a comment'
  D: "tab\\there"
  U: 1_000
  M: -12
  INF: -.inf  # trailing comment
  PINF: +.inf
  P: plain text
B:
  C:
    D: 3
"""


def test_yaml_parser_scalars_equal_pyyaml():
    assert load_yaml(SCALARS) == yaml.safe_load(SCALARS)


@pytest.mark.parametrize("name", NAMES)
def test_model_cfg_matches_jax(name):
    port = _flat(load_model_cfg(name))
    ref = _flat(jax_load_model_cfg(name))
    shared = {k for k in ref if not k.startswith("TPU.")}
    assert set(port) == shared | {"CUDA.COMPUTE_DTYPE", "CUDA.PARAM_DTYPE", "CUDA.SEED",
                                  "CUDA.PREFETCH_DEPTH", "CUDA.REMAT", "CUDA.REMAT_POLICY"}
    for k in shared:
        assert port[k] == ref[k] and type(port[k]) is type(ref[k]), k
    for k in ("REMAT", "REMAT_POLICY"):  # the JAX TPU.* keys' defaults
        assert port[f"CUDA.{k}"] == ref[f"TPU.{k}"], k


def test_merge_from_list_coerces_literals():
    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.DEPTH", "18", "MODEL.LR", "1e-3",
                         "MODEL.FUSE", "False", "CUDA.COMPUTE_DTYPE", "float32",
                         "CHALEARN.ROOT", "/tmp/x"])
    assert cfg.MODEL.DEPTH == 18 and cfg.MODEL.LR == 1e-3
    assert cfg.MODEL.FUSE is False and cfg.CUDA.COMPUTE_DTYPE == "float32"
    with pytest.raises(KeyError):
        cfg.merge_from_list(["MODEL.NOPE", "1"])
    with pytest.raises(ValueError):
        cfg.merge_from_list(["MODEL.DEPTH", "deep"])
    with pytest.raises(ValueError):
        cfg.merge_from_list(["MODEL.DEPTH"])


def test_clone_and_freeze():
    cfg = load_model_cfg("slowfast-HTAH")
    other = cfg.clone()
    other.MODEL.DEPTH = 18
    assert cfg.MODEL.DEPTH == 50
    cfg.freeze()
    with pytest.raises(AttributeError):
        cfg.MODEL.DEPTH = 18
    cfg.defrost()
    cfg.MODEL.DEPTH = 18
    assert cfg.MODEL.DEPTH == 18
