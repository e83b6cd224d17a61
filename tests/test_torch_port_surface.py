"""The port covers the JAX package's surface, or says why not.

Every name exported by a JAX subpackage (its ``__all__``, or the public
names its ``__init__`` imports), every module, every CLI subcommand, every
config key, every ``FlowParams`` field and every ``save_checkpoint`` option
has a counterpart in ``video_classification_tpu_torch`` under the same
name, one under another name (``RENAMED``), or a row in ``NOT_PORTED`` with
its reason. The rows are ROADMAP's "Deliberately not ported" items, the
orbax checkpoint backend and ``bench``; a row whose name the JAX package no
longer has, or that the port has after all, fails too.
"""

import ast
import importlib
import inspect
from pathlib import Path

import pytest

from video_classification_tpu.config import get_cfg as jax_get_cfg
from video_classification_tpu.engine import checkpoint as jax_checkpoint
from video_classification_tpu.ops import flow as jax_flow
from video_classification_tpu_torch.config import get_cfg
from video_classification_tpu_torch.config.node import TPU_ROUTES, TPU_TO_CUDA
from video_classification_tpu_torch.engine import checkpoint as port_checkpoint
from video_classification_tpu_torch.ops import flow as port_flow
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
JAX, PORT = "video_classification_tpu", "video_classification_tpu_torch"
SUBPACKAGES = ("config", "data", "detect", "engine", "models", "ops", "parallel",
               "pipeline", "utils", "v2")
MESH = "a jax.sharding Mesh: the port's data axis is the torch.distributed world, one " \
       "rank per card (parallel/multihost.py, the Trainer's data-parallel path)"

# JAX name -> the port's name for the same thing.
RENAMED = {
    "detect.load_densepose_variables": "detect.load_densepose_state_dict",
    "models/torch_convert.py": "models/convert.py",
    "detect/pallas_nms.py": "csrc/nms.cu",
    "ops/pallas_components.py": "csrc/component_extents.cu",
    "ops/pallas_flow.py": "csrc/flow_level.cu",
}
# JAX name -> why the port has no counterpart.
NOT_PORTED = {
    "detect.d2_to_flax": "flax variables: the port's DensePoseRCNN keeps detectron2's "
                         "state_dict names, so a pkl loads as it is (load_d2_pkl)",
    "engine.TrainState": "flax's train state pytree: the port's Trainer holds an "
                         "nn.Module and a torch.optim optimizer",
    "parallel.make_mesh": MESH,
    "parallel.data_sharding": MESH,
    "parallel.replicated": MESH,
    "parallel.shard_batch": MESH,
    "parallel.replicate": MESH,
    "parallel.visible_device_count": MESH,
    "parallel.assemble_fake_multihost": MESH,
    "parallel.global_batch_from_local": MESH,
    "cli.bench": "runs the root bench.py, the benchmark of earlier work; the port's "
                 "benchmark comes with the `benchmark` PR that writes BENCHMARK.json",
    "save_checkpoint.backend": "the orbax backend needs tensorstore, which the card's "
                               "machine lacks; the port writes its own format and reads "
                               "the msgpack backend's files (the default)",
    **{f"FlowParams.{f}": "chooses between TPU routes (XLA, Pallas, warp tiers, the "
                          "fused stack); a CUDA tensor always launches the port's kernels"
       for f in ("backend", "warp", "warp_tiers", "fuse_stack", "fuse_warp_radius")},
    **{f"TPU.{k}": "a TPU route (mesh, buffer donation, the packed fast pathway, XLA's "
                   "compile cache), read and ignored with a warning" for k in TPU_ROUTES},
}


def _exports(sub):
    mod = importlib.import_module(f"{JAX}.{sub}")
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    tree = ast.parse(Path(mod.__file__).read_text())
    return [a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
            for a in node.names if not (a.asname or a.name).startswith("_")]


def _ported(kind, key, found):
    """Checks one JAX name: found in the port, renamed, or a row."""
    if key in NOT_PORTED:
        assert not found(key), f"{kind} {key} is ported after all: drop its row"
        return
    target = RENAMED.get(key, key)
    assert found(target), f"{kind} {key} has no counterpart in the port and no row"


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_export_has_a_counterpart(sub):
    port = importlib.import_module(f"{PORT}.{sub}")
    names = _exports(sub)
    assert names
    for name in names:
        _ported("export", f"{sub}.{name}", lambda key: hasattr(
            importlib.import_module(f"{PORT}.{key.split('.')[0]}"), key.split(".")[1]))
    if hasattr(port, "__all__"):
        assert all(hasattr(port, n) for n in port.__all__)


def test_every_jax_module_has_a_counterpart():
    modules = sorted(str(p.relative_to(ROOT / JAX)) for p in (ROOT / JAX).rglob("*.py"))
    assert len(modules) > 50
    for rel in modules:
        _ported("module", rel, lambda key: (ROOT / PORT / key).is_file())


def _subcommands(path):
    tree = ast.parse(path.read_text())
    return sorted(node.args[0].value for node in ast.walk(tree)
                  if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_parser"
                  and node.args and isinstance(node.args[0], ast.Constant))


def test_every_cli_subcommand_has_a_counterpart():
    from video_classification_tpu_torch.__main__ import NOT_PORTED as CLI_NOT_PORTED

    jax_cmds = _subcommands(ROOT / JAX / "__main__.py")
    port_cmds = _subcommands(ROOT / PORT / "__main__.py")
    assert "train" in jax_cmds and "render-iuv" in jax_cmds
    for cmd in jax_cmds:
        _ported("subcommand", f"cli.{cmd}",
                lambda key: key[4:] in port_cmds and key[4:] not in CLI_NOT_PORTED)


def _flat(node, prefix=""):
    out = []
    for k, v in node.items():
        out += _flat(v, f"{prefix}{k}.") if isinstance(v, dict) else [f"{prefix}{k}"]
    return out


def test_every_config_key_has_a_counterpart():
    port_keys = set(_flat(get_cfg()))
    renamed = {f"TPU.{k}": f"CUDA.{k}" for k in TPU_TO_CUDA}
    jax_keys = _flat(jax_get_cfg())
    assert len(jax_keys) > 40
    for key in jax_keys:
        _ported("config key", key, lambda k: renamed.get(k, k) in port_keys)


def test_every_flow_parameter_and_checkpoint_option_has_a_counterpart():
    port_fields = set(port_flow.FlowParams._fields)
    for field in jax_flow.FlowParams._fields:
        _ported("FlowParams field", f"FlowParams.{field}", lambda k: k[11:] in port_fields)
    params = set(inspect.signature(port_checkpoint.save_checkpoint).parameters) | {"variables"}
    for name in inspect.signature(jax_checkpoint.save_checkpoint).parameters:
        _ported("save_checkpoint option", f"save_checkpoint.{name}",
                lambda k: k.split(".")[1] in params)


def test_every_row_names_something_the_jax_package_has():
    jax_names = {f"{sub}.{n}" for sub in SUBPACKAGES for n in _exports(sub)}
    jax_names |= {f"cli.{c}" for c in _subcommands(ROOT / JAX / "__main__.py")}
    jax_names |= {f"FlowParams.{f}" for f in jax_flow.FlowParams._fields}
    jax_names |= {f"save_checkpoint.{p}" for p in
                  inspect.signature(jax_checkpoint.save_checkpoint).parameters}
    jax_names |= set(_flat(jax_get_cfg()))
    jax_names |= {str(p.relative_to(ROOT / JAX)) for p in (ROOT / JAX).rglob("*.py")}
    assert set(NOT_PORTED) | set(RENAMED) <= jax_names
