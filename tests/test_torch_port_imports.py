"""Import hygiene, device policy and build toolchain of the PyTorch port.

Run in subprocesses, because tests/conftest.py imports jax:
importing every module of ``video_classification_tpu_torch`` (the train,
ensemble, offline-chain and v2 slices' among them) pulls in neither jax,
flax, optax, the JAX package nor cv2; ``python -m video_classification_tpu_torch
--help`` lists the JAX CLI's subcommands; ``chip_smoke.py`` refuses to run
without CUDA, and outside a checkout.
In-process: entry points default to CUDA and raise when there is none; the
kernel build keeps a C++ compiler only if it links the shared libstdc++.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "video_classification_tpu_torch"
FORBIDDEN = ("jax", "flax", "optax", "video_classification_tpu")
TRAIN_SLICE = ("data.dataset", "data.pipeline", "engine.trainer", "ops.segment",
               "profile_train", "utils.labels", "utils.logging")
ENSEMBLE_SLICE = ("__main__", "engine.sparse", "models.res3d", "models.resnet2d",
                  "models.sparse_fusion", "tools")
OFFLINE_SLICE = ("data.fixture", "detect.provider", "pipeline.frame_io",
                 "pipeline.iuv_contract", "pipeline.stages", "profile_preprocess",
                 "utils.chapath", "utils.chunked")
V2_SLICE = ("models.raft", "models.raft_convert", "profile_v2", "v2", "v2.convert",
            "v2.dataset", "v2.part_compose", "v2.trainer", "v2.video_io")


def _run(code_or_args, cwd=ROOT):
    args = code_or_args if isinstance(code_or_args, list) else ["-c", code_or_args]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import video_classification_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN + ('cv2',)!r}]\n"
        "assert not bad, bad\n"
        f"missing = [m for m in {TRAIN_SLICE + ENSEMBLE_SLICE + OFFLINE_SLICE + V2_SLICE!r}\n"
        "           if p.__name__ + '.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
        "print('modules', len([m for m in sys.modules if m.startswith(p.__name__)]))\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 60


def test_cli_help_lists_the_jax_subcommands():
    out = _run(["-m", "video_classification_tpu_torch", "--help"])
    assert out.returncode == 0, out.stderr
    for cmd in ("train", "train-parts", "train-parallel", "eval", "preprocess",
                "sparse-dump", "sparse-train", "v2-convert", "v2-train", "infer", "bench",
                "tools"):
        assert cmd in out.stdout, cmd
    out = _run(["-m", "video_classification_tpu_torch", "tools", "--help"])
    assert out.returncode == 0 and "how-many-classes" in out.stdout


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT) for p in PORT.rglob("*.py")] + [Path("chip_smoke.py")]))
def test_no_jax_imports_in_source(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, f"{path} imports {n}"


def test_entry_points_raise_without_cuda():
    from video_classification_tpu_torch.config import get_cfg
    from video_classification_tpu_torch.engine import (EnsemblePredictor, Predictor,
                                                       SparseTrainer, Trainer)
    from video_classification_tpu_torch.utils.cuda import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for entry in (Predictor, Trainer, SparseTrainer):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry(get_cfg())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EnsemblePredictor()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_v2_needs_the_card_unless_asked_for_the_cpu(tmp_path):
    """The v2 converters, the model manager and the trainer resolve their
    device first; a missing card never moves them to the CPU."""
    from video_classification_tpu_torch.config import get_cfg
    from video_classification_tpu_torch.models.raft_convert import write_synthesized_checkpoint
    from video_classification_tpu_torch.pipeline.frame_io import ArrayFrameIO
    from video_classification_tpu_torch.v2 import (ConvertIuvPklToPartBox,
                                                   ConvertVideoToFlow, V2ModelManager,
                                                   V2Trainer)

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_cfg()
    cfg.CHALEARN.ROOT = str(tmp_path)
    io = ArrayFrameIO()
    ckpt = write_synthesized_checkpoint(tmp_path / "raft.pth")
    for call in (lambda: ConvertVideoToFlow(cfg, io=io),
                 lambda: ConvertVideoToFlow(cfg, method="raft", io=io, raft_checkpoint=ckpt),
                 lambda: ConvertIuvPklToPartBox(cfg, io=io),
                 lambda: V2ModelManager(cfg),
                 lambda: V2Trainer(cfg, io=io)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    ConvertIuvPklToPartBox(cfg, io=io, device="cpu").convert()  # no pickles, on the CPU


def test_offline_chain_needs_the_card_unless_asked_for_the_cpu(tmp_path):
    """The provider and the device stages resolve their device first; a
    missing cv2 or card never moves them to the CPU or to other I/O."""
    import numpy as np

    from video_classification_tpu_torch.config import get_cfg
    from video_classification_tpu_torch.detect.provider import DensePoseIUVProvider
    from video_classification_tpu_torch.pipeline import stages
    from video_classification_tpu_torch.pipeline.frame_io import ArrayFrameIO

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_cfg()
    cfg.CHALEARN.ROOT = str(tmp_path)
    io = ArrayFrameIO()
    for call in (
            lambda: DensePoseIUVProvider(depth=50, allow_random_init=True),
            lambda: stages.video_flow_images(np.zeros((2, 8, 8, 3), np.uint8)),
            lambda: stages.filter_img_by_flow(cfg, io=io),
            lambda: stages.iuv_to_crop(cfg, io=io),
            lambda: stages.run_stages(cfg, ["crop"], io=io)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    stages.iuv_to_crop(cfg, io=io, device="cpu")  # nothing to crop, on the CPU


def test_chip_smoke_fails_without_cuda_and_outside_a_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(["chip_smoke.py"])
    assert out.returncode != 0 and '"ok"' not in out.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run(["chip_smoke.py"], cwd=tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_cpu_kernels_never_build(tmp_path, monkeypatch):
    """CPU tensors take the plain versions: no nvcc is needed or called."""
    from video_classification_tpu_torch.detect.nms import nms
    from video_classification_tpu_torch.ops.component_extents import component_extents
    from video_classification_tpu_torch.ops.flow_level import flow_level
    from video_classification_tpu_torch.ops.label_components import label_components
    from video_classification_tpu_torch.ops.sor_solve import sor_solve
    from video_classification_tpu_torch.ops.warp import warp_bilinear
    from video_classification_tpu_torch.utils import cuda

    def refuse(*_a, **_k):
        raise AssertionError("a CPU call tried to build a kernel")

    monkeypatch.setattr(cuda, "build", refuse)
    im = torch.rand((1, 8, 9, 3))
    u, v, mx = flow_level(im, im, torch.zeros((1, 8, 9)), torch.zeros((1, 8, 9)),
                          1, 2, 0.012, 1.8, 1e-6, 8, 0.0)
    assert u.shape == (1, 8, 9) and mx.shape == (1,)
    assert len(component_extents(torch.ones((1, 4, 4), dtype=torch.bool))) == 4
    boxes = torch.tensor([[[0.0, 0.0, 4.0, 4.0], [1.0, 1.0, 4.0, 4.0]]])
    idx, mask = nms(boxes, torch.tensor([[0.5, 0.9]]), 2, 0.5)
    assert idx.tolist() == [[1, 0]] and mask.tolist() == [[True, False]]
    z = torch.zeros((1, 8, 9))
    du, dv = sor_solve(z + 1, z, z + 1, z, z, z, z, z, z, z, z, 2, 0.012, 1.8)
    assert du.shape == dv.shape == (1, 8, 9)
    assert warp_bilinear(im, z, z).shape == (1, 8, 9, 3)
    assert label_components(torch.ones((1, 4, 4), dtype=torch.bool)).max() == 0
    launches = (flow_level, component_extents, nms, sor_solve, warp_bilinear,
                label_components)
    assert all(k.launches == 0 for k in launches)


def _fake_compiler(path, shared, static):
    """A compiler script that answers -print-file-name like a GCC whose
    library directories hold ``shared`` and ``static`` (paths or None)."""
    path.write_text(
        "#!/bin/sh\n"
        f'case "$1" in -print-file-name=libstdc++.so) echo {shared or "libstdc++.so"} ;;\n'
        f'  -print-file-name=libstdc++.a) echo {static or "libstdc++.a"} ;; esac\n')
    path.chmod(0o755)
    return str(path)


def test_build_keeps_only_a_compiler_that_links_the_shared_cxx_runtime(tmp_path):
    """A C++ compiler that would link the static libstdc++ (an extension
    with its own copy crashes on a failed TORCH_CHECK with a formatted
    message) is replaced by the system's c++ and cc."""
    from video_classification_tpu_torch.utils.cuda import links_shared_libstdcxx, toolchain

    lib = tmp_path / "lib"
    lib.mkdir()
    for name in ("libstdc++.so", "libstdc++.a"):
        (lib / name).touch()
    (tmp_path / "static").mkdir()
    (tmp_path / "static" / "libstdc++.a").touch()
    good = _fake_compiler(tmp_path / "good", lib / "libstdc++.so", lib / "libstdc++.a")
    static_only = _fake_compiler(tmp_path / "static_only", None, tmp_path / "static" / "libstdc++.a")
    static_first = _fake_compiler(tmp_path / "static_first", lib / "libstdc++.so",
                                  tmp_path / "static" / "libstdc++.a")
    assert links_shared_libstdcxx(good)
    assert not links_shared_libstdcxx(static_only)
    assert not links_shared_libstdcxx(static_first)
    assert not links_shared_libstdcxx(str(tmp_path / "missing"))
    assert toolchain({"CXX": good, "CC": "/x/cc"}) == {"CXX": good, "CC": "/x/cc"}
    if not (shutil.which("c++") and links_shared_libstdcxx(shutil.which("c++"))):
        pytest.skip("the system c++ does not link the shared libstdc++ here")
    chosen = toolchain({"CXX": static_only, "CC": "/x/cc"})
    assert chosen == {"CXX": shutil.which("c++"), "CC": shutil.which("cc")}
