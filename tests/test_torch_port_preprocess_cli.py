"""``python -m video_classification_tpu_torch preprocess``: the offline
chain through the port's CLI (CPU).

``VCT_PLATFORM=cpu python -m video_classification_tpu_torch preprocess
--provider synthetic`` (every stage, cv2 I/O) writes the stage folders
that the JAX CLI writes on the same raw fixture; ``--provider densepose``
without ``--densepose-pkl`` refuses before any stage runs, and a stage list
without IUV builds no provider.
"""

import contextlib
import io
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from video_classification_tpu import __main__ as jax_cli
from video_classification_tpu.config import get_cfg as jax_get_cfg
from video_classification_tpu.data.fixture import generate_raw_fixture
from test_torch_port_cli import _run
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)


def test_preprocess_writes_the_jax_clis_stage_folders(tmp_path, monkeypatch):
    roots = {k: tmp_path / k for k in ("jax", "port")}
    cfg = jax_get_cfg()
    cfg.CHALEARN.ROOT = str(roots["jax"])
    generate_raw_fixture(cfg, num_videos_per_set=1, num_classes=1, num_frames=6,
                         sets=("train", "test"))
    shutil.copytree(roots["jax"], roots["port"])
    argv = ["preprocess", "--provider", "synthetic", "--sets", "train", "test",
            "--stages", "sample", "images", "flow", "energy", "pad", "iuv", "cse", "crop",
            "--opts", "CHALEARN.SAMPLE_CLASS", "1"]
    monkeypatch.setenv("VCT_PLATFORM", "cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        assert jax_cli.main(argv + ["--root", str(roots["jax"])]) in (0, None)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "video_classification_tpu_torch", *argv,
                          "--root", str(roots["port"])], cwd=Path(__file__).parent.parent,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr

    def files(root):
        return sorted(p.relative_to(root).as_posix() for p in root.rglob("*") if p.is_file())

    want = files(roots["jax"])
    assert files(roots["port"]) == want
    assert {f.split("/")[0] for f in want} >= {
        "1_Sample", "2_Images", "2_Flow", "2_Images_energy", "3_Pad", "4_IUV", "4_CSE",
        "CropBody", "CropHTAH", "CropLHand", "CropRHand", "CropLHandArm", "CropRHandArm",
        "CropTorso"}


def test_preprocess_densepose_needs_weights(tmp_path, monkeypatch):
    monkeypatch.setenv("VCT_PLATFORM", "cpu")
    with pytest.raises(SystemExit, match="--densepose-pkl"):
        _run(["preprocess", "--root", str(tmp_path), "--stages", "iuv"])
    rc, _, _ = _run(["preprocess", "--root", str(tmp_path), "--stages", "pad"])
    assert rc == 0  # nothing to pad, and no provider is built
