"""The port's temporal halo exchange (parallel/temporal.py) on two gloo ranks
(CPU, two processes with a timeout of their own and a free port).

``conv3d_temporal_sharded`` on each rank's block of 4 of 8 frames, with kt
1, 3 and 5 and a 3x3x3 kernel (``torch_port_ranks.temporal_cases``, numpy
seeds):

  * every rank's block, and the blocks gathered over T, bit-equal to the
    unsharded ``F.conv3d`` with SAME padding (torch.equal);
  * the gathered output against the JAX package's
    ``conv3d_temporal_sharded`` on two of the eight virtual CPU devices
    (inputs transposed to (N, T, H, W, C) and (kt, kh, kw, Cin, Cout)),
    within 1e-5;
  * a block shorter than the halo raises.
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from video_classification_tpu.parallel import make_mesh
from video_classification_tpu.parallel.temporal import conv3d_temporal_sharded as jax_sharded
from video_classification_tpu_torch.parallel import conv3d_temporal_sharded
from torch_port_ranks import run_ranks, temporal_cases
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("temporal")
    for rc, stdout, err in run_ranks(["tests/torch_port_ranks.py", "temporal", str(out)]):
        assert rc == 0, err[-3000:]
    return [torch.load(out / f"rank{r}.pt") for r in range(2)]


def _unsharded(x, w):
    kt, kh, kw = w.shape[2:]
    return F.conv3d(torch.from_numpy(x), torch.from_numpy(w),
                    padding=(kt // 2, kh // 2, kw // 2))


@pytest.mark.parametrize("case", [c[0] for c in temporal_cases()])
def test_sharded_equals_the_unsharded_conv(ranks, case):
    x, w = next((x, w) for name, x, w in temporal_cases() if name == case)
    want = _unsharded(x, w)
    t = want.shape[2] // 2
    for r, got in enumerate(ranks):
        assert torch.equal(got[case]["local"], want[:, :, r * t:(r + 1) * t]), (case, r)
        assert torch.equal(got[case]["gathered"], want), case


@pytest.mark.parametrize("case", [c[0] for c in temporal_cases()])
def test_sharded_matches_jax(ranks, devices, case):
    x, w = next((x, w) for name, x, w in temporal_cases() if name == case)
    got = ranks[0][case]["gathered"].numpy()
    want = np.asarray(jax_sharded(np.transpose(x, (0, 2, 3, 4, 1)),
                                  np.transpose(w, (2, 3, 4, 1, 0)),
                                  make_mesh(devices=devices[:2])))
    np.testing.assert_allclose(np.transpose(got, (0, 2, 3, 4, 1)), want, atol=1e-5, rtol=1e-5)
    assert jax.devices()[0].platform == "cpu"


def test_a_block_shorter_than_the_halo_raises():
    with pytest.raises(ValueError, match="halo"):
        conv3d_temporal_sharded(torch.zeros((1, 2, 1, 4, 4)), torch.zeros((3, 2, 5, 1, 1)))
