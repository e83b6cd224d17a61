"""``tools.render_iuv_boxes`` of the port against the JAX package's (CPU).

  * ``draw_rectangle`` sets exactly the pixels of ``cv2.rectangle(img, p1,
    p2, (0, 0, 255), 2)``: Hypothesis over image sizes and corners inside,
    on and far past the border, in either order, degenerate boxes too;
  * through ``Cv2FrameIO`` the port writes the JAX tool's JPEG files, byte
    for byte, from the same IUV pickle and video (boxes from the padded
    frame shifted back by half the frame size, frames without a detection
    skipped, ``max_frames``), and through ``ArrayFrameIO`` the same frames
    losslessly.
"""

import pickle

import cv2
import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

from video_classification_tpu import tools as jax_tools
from video_classification_tpu_torch.pipeline.frame_io import ArrayFrameIO, Cv2FrameIO
from video_classification_tpu_torch.tools import draw_rectangle, render_iuv_boxes
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)

corner = st.integers(-60, 120)


@settings(max_examples=300, deadline=None, derandomize=True)
@given(h=st.integers(1, 70), w=st.integers(1, 70), x1=corner, y1=corner, x2=corner,
       y2=corner)
def test_draw_rectangle_is_cv2_rectangle(h, w, x1, y1, x2, y2):
    img = np.random.RandomState(h * w).randint(0, 200, (h, w, 3)).astype(np.uint8)
    want = cv2.rectangle(img.copy(), (x1, y1), (x2, y2), (0, 0, 255), 2)
    got = draw_rectangle(img.copy(), (x1, y1), (x2, y2), (0, 0, 255))
    np.testing.assert_array_equal(got, want)


def _fixture(tmp_path):
    rng = np.random.RandomState(0)
    frames = rng.randint(0, 255, (6, 40, 56, 3)).astype(np.uint8)
    video = tmp_path / "M_00001.avi"
    Cv2FrameIO().write_video(video, list(frames))
    boxes = [[30.7, 22.2, 60.9, 51.5], [28.0, 20.0, 84.0, 60.0], None,
             [10.0, -4.5, 200.0, 33.3], [40.0, 30.0, 41.0, 31.0], [0.0, 0.0, 111.9, 79.9]]
    results = [{"pred_boxes_XYXY": (np.zeros((0, 4), np.float32) if b is None else
                                    np.asarray([b, [0, 0, 5, 5]], np.float32)),
                "scores": np.zeros(0 if b is None else 2, np.float32)} for b in boxes]
    pkl = tmp_path / "M_00001.pkl"
    with pkl.open("wb") as f:
        pickle.dump(results, f)
    return frames, video, pkl


def test_render_writes_the_jax_files(tmp_path, capsys):
    _, video, pkl = _fixture(tmp_path)
    want = jax_tools.render_iuv_boxes(pkl, video, tmp_path / "jax", max_frames=5)
    jax_out = capsys.readouterr().out
    got = render_iuv_boxes(pkl, video, tmp_path / "port", max_frames=5, io=Cv2FrameIO())
    assert got == want == 4 and capsys.readouterr().out == jax_out == "No detection\n"
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == ["00000.jpg", "00001.jpg", "00003.jpg", "00004.jpg"]
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes(), n


def test_render_through_array_frame_io(tmp_path):
    frames, video, pkl = _fixture(tmp_path)
    io = ArrayFrameIO()
    io.write_video(tmp_path / "M_00001.npy.avi", list(Cv2FrameIO().read_video(video)))
    n = render_iuv_boxes(pkl, tmp_path / "M_00001.npy.avi", tmp_path / "out", io=io)
    assert n == 5
    decoded = Cv2FrameIO().read_video(video)
    img = io.imread(tmp_path / "out" / "00001.jpg")
    want = draw_rectangle(decoded[1].copy(), (28 - 28, 20 - 20), (84 - 28, 60 - 20),
                          (0, 0, 255))
    np.testing.assert_array_equal(img, want)
    np.testing.assert_array_equal(img[0, 0], [0, 0, 255])
