"""K3 past N = 8192, where ``csrc/nms.cu`` takes its device-memory route
(CPU; the kernel itself is held on the card by ``chip_smoke.py`` [38]).

  * ``route`` switches from 'shared' to 'device' past N = 8192, as the
    source's ``nms_smem_bytes`` against one block's 232,448 bytes says;
  * ``nms_reference`` (the CPU path and the kernel's oracle) against the
    JAX package's XLA ``detect/ops.nms`` at N = 10000 and 20000, dense boxes,
    thresholds 0.7 and 0.5, 1000 slots: indices and mask exact;
  * the kernel's schedule (the bitonic network on the padded keys, then the
    64-candidate chunk scan), emulated on the CPU as
    test_torch_port_nms_chunks.py does, equal to ``nms_reference`` at N =
    10000: the device-memory route runs that same schedule.

Boxes and scores are made with numpy from seeds.
"""

import numpy as np
import pytest
import torch

from video_classification_tpu.detect.ops import nms as jax_nms
from video_classification_tpu_torch.detect.nms import nms, nms_reference, route
from video_classification_tpu_torch.utils import cuda
from test_torch_port_nms_chunks import _boxes, chunked_scan
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)


def test_route_switches_past_8192():
    assert [route(n) for n in (1, 1264, 5000, 8192)] == ["shared"] * 4
    assert [route(n) for n in (8193, 10000, 20000, 1 << 20)] == ["device"] * 4
    source = (cuda.CSRC / "nms.cu").read_text()
    assert "nms_sorted_kernel<false>" in source and "nms_sorted_kernel<true>" in source
    assert "nms_route" in (cuda.CSRC / "bindings.cpp").read_text()


@pytest.mark.parametrize("n", [10000, 20000])
@pytest.mark.parametrize("thr", [0.7, 0.5])
def test_reference_equals_jax_past_8192(n, thr):
    boxes, scores = _boxes(n, seed=n + int(thr * 10), extent=1200.0)
    idx, mask = nms_reference(torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None],
                              1000, thr)
    jidx, jmask = jax_nms(boxes, scores, 1000, thr, "xla")
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(mask[0].numpy(), np.asarray(jmask))
    assert 100 < int(mask.sum()) <= 1000
    # The wrapper takes any N on the CPU (the plain path).
    got = nms(torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None], 1000, thr)
    assert torch.equal(got[0], idx) and torch.equal(got[1], mask)


def test_kernel_schedule_equals_the_reference_past_8192():
    boxes, scores = _boxes(10000, seed=3, extent=1200.0)
    scores[::97] = scores[1::97][:len(scores[::97])]  # ties
    idx, mask, trace = chunked_scan(boxes, scores, 1000, 0.7)
    ridx, rmask = nms_reference(torch.from_numpy(boxes)[None],
                                torch.from_numpy(scores)[None], 1000, 0.7)
    assert torch.equal(idx, ridx[0]) and torch.equal(mask, rmask[0])
    assert len(trace) > 1
