"""One short run of each cell on the card (skips without one):

    python3 -m pytest port_bench/tests -q -m cuda
"""

import json
import subprocess
import sys

import pytest

from .conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_cell_runs_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", workload,
                          "--seed", "2147483659", "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
