"""The v2 ``VideoIO`` of the port (``v2/video_io.py``) against the JAX
package's (CPU, the same cv2).

  * through ``Cv2FrameIO``: a (T, C, H, W) array written by either package
    reads back equal through the other (the same MJPG files, bit for bit),
    gray channel files named ``{c}_<name>``, indexed reads (repeated and
    unordered indices) of gray and rgb24 videos, full reads, frame counts and
    frame sizes; an index past the end raises;
  * through ``ArrayFrameIO``: the round trip is lossless (gray stacks and
    rgb24 reads of colour stacks), with counts and sizes from the stack;
  * the part-box algebra (``v2/part_compose.py``) equals the JAX package's.
"""

import numpy as np
import pytest

from video_classification_tpu.v2 import VideoIO as JaxVideoIO
from video_classification_tpu.v2 import part_compose as jax_pc
from video_classification_tpu_torch.pipeline.frame_io import ArrayFrameIO, Cv2FrameIO
from video_classification_tpu_torch.v2 import PartCompose, VideoIO, part_compose
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)


def _smooth(rng, t, c, h, w):
    """Low-frequency uint8 content (MJPG is lossy) with some texture."""
    base = rng.randint(30, 200, (t, c, 1, 1))
    yy, xx = np.mgrid[0:h, 0:w]
    ramp = (xx * 2 + yy)[None, None] % 40
    return np.clip(base + ramp, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tchw_files_cross_read_through_cv2(tmp_path, writer):
    rng = np.random.RandomState(0)
    arr = _smooth(rng, 6, 2, 32, 48)
    port = VideoIO(Cv2FrameIO())
    path = tmp_path / writer / "M_00001.avi"
    (port.write_video_TCHW if writer == "port" else JaxVideoIO.write_video_TCHW)(path, arr)
    assert sorted(p.name for p in path.parent.iterdir()) == ["0_M_00001.avi",
                                                             "1_M_00001.avi"]
    other = tmp_path / ("jax" if writer == "port" else "port") / "M_00001.avi"
    (JaxVideoIO.write_video_TCHW if writer == "port" else port.write_video_TCHW)(other, arr)
    for c in (0, 1):  # the same encoder, the same bytes
        assert (path.parent / f"{c}_{path.name}").read_bytes() == (
            other.parent / f"{c}_{other.name}").read_bytes()
    frames = [5, 0, 3, 3]
    got = port.read_video_TCHW(path, 2, frames)
    want = JaxVideoIO.read_video_TCHW(path, 2, frames)
    assert got.shape == (4, 2, 32, 48) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert np.abs(got.astype(int) - arr[frames].astype(int)).mean() < 3
    assert port.frame_count(path.parent / "0_M_00001.avi") == JaxVideoIO.frame_count(
        path.parent / "0_M_00001.avi") == 6
    assert port.frame_size(path.parent / "1_M_00001.avi") == (32, 48)
    with pytest.raises(IndexError):
        port.read_video_TCHW(path, 2, [6])


def test_rgb24_reads_match_jax(tmp_path):
    import cv2

    path = tmp_path / "rgb.avi"
    rng = np.random.RandomState(1)
    colour = _smooth(rng, 5, 3, 28, 36).transpose(0, 2, 3, 1).copy()
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10, (36, 28))
    for f in colour:
        writer.write(f)
    writer.release()
    port = VideoIO(Cv2FrameIO())
    np.testing.assert_array_equal(port.read_video_TCHW(path, 0, [4, 1], format="rgb24"),
                                  JaxVideoIO.read_video_TCHW(path, 0, [4, 1], format="rgb24"))
    for fmt in ("rgb24", "gray"):
        got, want = port.read_video(path, fmt), JaxVideoIO.read_video(path, fmt)
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert port.frame_size(path) == (28, 36)


def test_array_frame_io_round_trip_is_lossless(tmp_path):
    rng = np.random.RandomState(2)
    arr = rng.randint(0, 256, (7, 2, 20, 24)).astype(np.uint8)
    vio = VideoIO(ArrayFrameIO())
    path = tmp_path / "2_Flow_New" / "train" / "001" / "M_00001.avi"
    vio.write_video_TCHW(path, arr)
    assert sorted(p.name for p in path.parent.iterdir()) == ["0_M_00001.avi",
                                                             "1_M_00001.avi"]
    np.testing.assert_array_equal(vio.read_video_TCHW(path, 2, [6, 0, 2]), arr[[6, 0, 2]])
    np.testing.assert_array_equal(vio.read_video_TCHW(path, 2, range(7)), arr)
    assert vio.frame_count(path.parent / "0_M_00001.avi") == 7
    assert vio.frame_size(path.parent / "0_M_00001.avi") == (20, 24)
    with pytest.raises(IndexError):
        vio.read_video_TCHW(path, 2, [7])
    gray = vio.read_video(path.parent / "1_M_00001.avi", format="gray")
    np.testing.assert_array_equal(np.stack(gray), arr[:, 1])

    bgr = rng.randint(0, 256, (4, 20, 24, 3)).astype(np.uint8)
    video = tmp_path / "1_Sample" / "M_00002.avi"
    video.parent.mkdir(parents=True)
    ArrayFrameIO().write_video(video, list(bgr))
    np.testing.assert_array_equal(vio.read_video_TCHW(video, 0, [3, 1], format="rgb24"),
                                  bgr[[3, 1]][..., ::-1].transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(np.stack(vio.read_video(video)), bgr[..., ::-1])
    with pytest.raises(ValueError):
        vio.read_video(video, format="gray")  # a colour stack is not read in gray
    with pytest.raises(ValueError):
        vio.write_video(video, bgr)  # (T, H, W) only


def test_part_compose_matches_jax():
    for name in ("lHand", "rHand", "lUpArm", "rUpArm", "lLoArm", "rLoArm", "torso", "head",
                 "lArm", "rArm", "TorsoArmHand", "lHandLoArm", "lHandArm", "lHandArmTorso",
                 "rHandLoArm", "rHandArm", "rHandArmTorso"):
        assert getattr(part_compose, name) == getattr(jax_pc, name), name
        assert getattr(PartCompose, name) == getattr(jax_pc.PartCompose, name), name
    rng = np.random.RandomState(3)
    clip = []
    for _ in range(6):
        frame = [None] * 25
        for p in rng.choice(25, 8, replace=False):
            x, y = rng.randint(-20, 200, 2)
            frame[p] = (int(x), int(y), int(x + rng.randint(1, 50)), int(y + rng.randint(1, 50)))
        clip.append(frame)
    for parts in (part_compose.lHandArmTorso, part_compose.TorsoArmHand, [5, 6]):
        for frame in clip:
            assert (part_compose.combine_spatial_box_xyxy(frame, parts)
                    == jax_pc.combine_spatial_box_xyxy(frame, parts))
        if any(frame[p] is not None for frame in clip for p in parts):
            assert (part_compose.combine_temporal_box_xyxy(clip, parts)
                    == jax_pc.combine_temporal_box_xyxy(clip, parts))
        else:  # no frame has a box of these parts: both packages refuse
            for pc in (part_compose, jax_pc):
                with pytest.raises(AssertionError):
                    pc.combine_temporal_box_xyxy(clip, parts)
