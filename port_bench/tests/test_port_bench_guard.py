"""The run's guard against JAX and the JAX package, by whole top-level names."""

import subprocess
import sys

import pytest

from port_bench.harness.guard import forbidden_modules

from .conftest import ROOT


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                                  "video_classification_tpu", "video_classification_tpu.ops.flow",
                                  "bench", "benchmarks.run"])
def test_planted_module_fails(name):
    assert forbidden_modules(["torch", name]) == [name]


@pytest.mark.parametrize("name", ["video_classification_tpu_torch",
                                  "video_classification_tpu_torch.ops.flow", "jaxtyping",
                                  "benchmarking", "port_bench.harness"])
def test_other_names_pass(name):
    assert forbidden_modules([name]) == []


def test_harness_and_port_load_no_jax():
    """Importing everything a run imports leaves no forbidden module."""
    code = ("import port_bench.harness.core, port_bench.calibrate;"
            "from port_bench.harness.registry import Registry; r = Registry();"
            "[r.kind(k) for k in ('serve', 'train')];"
            "[r.model_of(w['config']) for w in r.benchmark['workloads']];"
            "import video_classification_tpu_torch.engine.predictor,"
            " video_classification_tpu_torch.engine.trainer;"
            "from port_bench.harness.guard import forbidden_modules;"
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_planted_jax_module_is_named():
    """The command refuses without a card; with a planted module the guard
    names it (the check every run makes once its window has closed)."""
    code = ("import sys, types; sys.modules['jax'] = types.ModuleType('jax');"
            "from port_bench.harness.guard import forbidden_modules; print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=60, check=True)
    assert out.stdout.strip() == "['jax']"
