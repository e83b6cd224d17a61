"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's files at
a size the CPU runs in seconds (``tiny_registry``), and the ``cuda`` marker
of the tests that need a card."""

import json
import shutil
from pathlib import Path

import pytest

PACKAGE = Path(__file__).resolve().parent.parent
ROOT = PACKAGE.parent

TINY_CONFIG = {
    "name": "tiny", "model": "slowfast_streams", "source": "test", "streams": ["slowfast-LHand"],
    "opts": {"CHALEARN.NUM_CLASS": 5, "CHALEARN.CLIP_LEN": 4, "CHALEARN.IMG_SAMPLE_INTERVAL": 5,
             "CHALEARN.BATCH_SIZE": 4, "MODEL.R3D_INPUT": "CropLHand", "MODEL.DEPTH": 18,
             "MODEL.LR": 0.0002, "CUDA.COMPUTE_DTYPE": "float32",
             "CUDA.PARAM_DTYPE": "float32", "CUDA.REMAT": True, "CUDA.REMAT_POLICY": "",
             "DATA.ONLINE_DETECTOR": "synthetic", "DATA.FLOW_OUTER": 2, "DATA.FLOW_SOR": 2,
             "DATA.FLOW_MIN_WIDTH": 16, "DEBUG": True},
    "flow": {"alpha": 0.012, "ratio": 0.75, "min_width": 16, "n_outer": 2, "n_sor": 2,
             "omega": 1.8, "eps": 1e-6, "warp_radius": 8, "outer_tol": 0.005},
}
TINY_ENSEMBLE = dict(TINY_CONFIG, name="tiny2", streams=["slowfast-LHand", "slowfast-RHand"],
                     opts={k: v for k, v in TINY_CONFIG["opts"].items()
                           if k not in ("MODEL.R3D_INPUT", "CHALEARN.BATCH_SIZE", "MODEL.LR")})
TINY_SERVE = {"kind": "serve", "height": 64, "width": 96, "lengths": [12, 45],
              "variants": 2, "speed": [1.5, 2.5], "blob": 0.08, "texture": [0.7, 0.9],
              "trace_requests": 2}
TINY_TRAIN = {"kind": "train", "pool": 12, "epoch_clips": 400, "trace_steps": 2}
# The tiny cells run float32 end to end on the CPU, where the program and
# the reference agree to float32 rounding; the limits hold them to that.
TINY_CELLS = {
    "tiny.serve": {"check": {"requests": 2},
                   "limits": {"logp_gap": 1e-3, "flow_off": 0.01, "clips_off": 0}},
    "tiny.ensemble": {"check": {"requests": 2},
                      "limits": {"logp_gap": 1e-3, "fused_gap": 1e-4, "flow_off": 0.01,
                                 "clips_off": 0}},
    "tiny.train": {"check": {"steps": 3},
                   "limits": {"grad_gap": 1e-3, "update_gap": 1e-3}},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


def write_tiny(dest: Path) -> Path:
    """A benchmark tree at ``dest`` (its package directory) with the tiny
    cells, the real kinds, model plug-ins, metric readers and counts;
    returns its BENCHMARK.json."""
    dest.mkdir(parents=True)
    for sub in ("kinds", "models", "metrics", "counts"):
        shutil.copytree(PACKAGE / sub, dest / sub, ignore=shutil.ignore_patterns("__pycache__"))
    for sub, files in (("configs", {"tiny": TINY_CONFIG, "tiny2": TINY_ENSEMBLE}),
                       ("traffic", {"tiny_serve": TINY_SERVE, "tiny_train": TINY_TRAIN}),
                       ("cells", TINY_CELLS)):
        (dest / sub).mkdir()
        for name, body in files.items():
            (dest / sub / f"{name}.json").write_text(json.dumps(body))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "test", "file": "x", "reduced": [], "why": "t"}]
    bench["workloads"] = [
        {"name": "tiny.serve", "config": "tiny", "traffic": "tiny_serve", "chips": 1, "why": "t"},
        {"name": "tiny.ensemble", "config": "tiny2", "traffic": "tiny_serve", "chips": 1, "why": "t"},
        {"name": "tiny.train", "config": "tiny", "traffic": "tiny_train", "chips": 1, "why": "t"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            train = any(w.startswith("train.") for w in m["workloads"])
            m["workloads"] = ["tiny.train"] if train else ["tiny.serve", "tiny.ensemble"]
    path = dest / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


@pytest.fixture
def tiny_registry(tmp_path):
    from port_bench.harness.registry import Registry

    bench = write_tiny(tmp_path / "bench")
    return Registry(tmp_path / "bench", bench)
