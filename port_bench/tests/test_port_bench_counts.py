"""The frozen work counts."""

import pytest

from port_bench.counts import flops, flow_ops
from port_bench.reference.flow import FlowParams, pyramid_shapes


def test_slowfast_htah_clip_flops():
    assert flops.clip_flops(249, 50, 20, 192) / 1e9 == pytest.approx(170.737, abs=5e-4)


def test_flow_top_level_bound():
    """K1's bound at the top level of 101 pairs of 240x320 is 0.994 ms."""
    per_pixel = flow_ops.ops_per_pixel_outer(3, 30)
    assert per_pixel == 1226
    ms = 101 * 240 * 320 * 7 * per_pixel / 67e12 * 1e3
    assert ms == pytest.approx(0.994, abs=5e-4)
    levels = pyramid_shapes(240, 320, 0.75, 20)
    assert levels == [(240, 320), (180, 240), (135, 180), (101, 135), (76, 101), (57, 76),
                      (43, 57), (32, 43), (24, 32)]
    pixels = sum(h * w for h, w in levels)
    assert flow_ops.pair_ops(240, 320, FlowParams()) == pixels * 7 * 1226


def test_crop_sizes():
    assert [flops.crop_size(f) for f in ("CropHTAH", "CropLHandArm", "CropLHand")] == [192, 128, 64]
