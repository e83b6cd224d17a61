"""The traffic generator: the mix's windows, and the same traffic for a seed."""

import numpy as np
import pytest

from port_bench.harness.registry import Registry
from port_bench.harness.traffic import ClipStream, ServeTraffic
from port_bench.reference.serve import window_indices

from .conftest import TINY_SERVE, TINY_TRAIN


def test_clip_span_windows():
    """A 100-frame video is one clip's span: one window, no frame repeated;
    every video of up to 120 raw frames costs that one window."""
    mix = Registry().traffic("v100")
    assert mix["lengths"] == [20 * 5]
    (w,) = window_indices(100, 20, 5)
    assert len(set(w[5::5].tolist())) == 20
    assert {len(window_indices(n, 20, 5)) for n in range(1, 121)} == {1}
    assert len(window_indices(121, 20, 5)) == 2


@pytest.mark.parametrize("n", [40, 100, 130, 220])
def test_windows_match_the_program(n):
    """The reference cuts a video as the program's sampler does."""
    from video_classification_tpu_torch.ops.sampling import num_uniform_clips

    assert len(window_indices(n, 20, 5)) == num_uniform_clips(-(-n // 5), 20)


def test_serve_traffic_is_deterministic():
    a, b = ServeTraffic(TINY_SERVE, 2**31 + 7, "cpu"), ServeTraffic(TINY_SERVE, 2**31 + 7, "cpu")
    c = ServeTraffic(TINY_SERVE, 2**31 + 8, "cpu")
    for key in a.videos:
        assert np.array_equal(a.videos[key][0], b.videos[key][0])
        assert np.array_equal(a.videos[key][1], b.videos[key][1])
    assert any(not np.array_equal(a.videos[k][0], c.videos[k][0]) for k in a.videos)
    ra, rb, rc = a.requests(), b.requests(), c.requests()
    n = a.cycle
    assert n == len(TINY_SERVE["lengths"]) * TINY_SERVE["variants"]
    first = [next(ra) for _ in range(4 * n)]
    assert first == [next(rb) for _ in range(4 * n)]
    other = [next(rc) for _ in range(4 * n)]
    assert first != other
    for cycle in range(4):   # every cycle holds each video once, whatever the seed
        for seq in (first, other):
            assert sorted(seq[n * cycle:n * (cycle + 1)]) == sorted(a.videos)


def test_motion_in_every_frame():
    rgb, depth = ServeTraffic(dict(TINY_SERVE, lengths=[120]), 5, "cpu").videos[(120, 0)]
    moved = np.abs(np.diff(rgb.astype(np.int16), axis=0)).reshape(119, -1).max(axis=1)
    assert (moved > 0).all()
    assert depth.shape == rgb.shape[:3] + (1,)


def test_clip_stream_is_deterministic_and_ordered():
    a = ClipStream(TINY_TRAIN, (4, 8, 8, 21), 5, 3, "cpu")
    b = ClipStream(TINY_TRAIN, (4, 8, 8, 21), 5, 3, "cpu")
    assert np.array_equal(a.clips, b.clips) and np.array_equal(a.labels, b.labels)
    got = [a.get_train_clip(i, None) for i in (7, 3, 9)]
    for k, item in enumerate(got):
        assert np.array_equal(item["x"], a.clips[k]) and item["label"] == a.labels[k]
