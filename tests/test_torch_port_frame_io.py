"""The offline chain's host utilities (CPU): ``utils/chapath.ChaPath``
against the JAX package's, ``utils/chunked.run_chunked``, and the frame
I/O of ``pipeline/frame_io``: ``ArrayFrameIO``'s lossless round trip and
its OpenCV conversions, ``Cv2FrameIO`` against direct ``cv2`` calls, and,
in a child process where ``import cv2`` fails, the stages, provider and
fixture modules still import while ``Cv2FrameIO()`` raises an ImportError
that names ``ArrayFrameIO``.
"""

import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from video_classification_tpu.utils.chapath import ChaPath as JaxChaPath
from video_classification_tpu_torch.pipeline.frame_io import ArrayFrameIO, Cv2FrameIO
from video_classification_tpu_torch.utils.chapath import ChaPath
from video_classification_tpu_torch.utils.chunked import run_chunked
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("path", ["/data/ChaLearn/CropHTAH/train/001/M_00001/00005.jpg",
                                  "rel/2_Images/test/249/K_35878/00000.jpg"])
def test_chapath_matches_jax(path):
    port, jax = ChaPath(path), JaxChaPath(path)
    for name, arg in (("change_split", "valid"), ("change_base", "CropTorso"),
                      ("prepend", "U_")):
        got, want = getattr(port, name)(arg), getattr(jax, name)(arg)
        assert str(got) == str(want) and os.fspath(got) == os.fspath(want)
        assert got.path == want.path and hash(got) == hash(want)
    chained = port.change_base("CropLHand").change_split("test").prepend("F3_")
    assert str(chained) == str(JaxChaPath(path).change_base("CropLHand")
                               .change_split("test").prepend("F3_"))
    assert port == ChaPath(Path(path)) and port == Path(path) and port == path
    assert port != ChaPath(path).prepend("D_")
    assert str(port) == os.fspath(port) == str(jax)


def test_run_chunked_keeps_order_and_moves_chunks_to_host():
    items = torch.arange(23, dtype=torch.float32).reshape(23, 1)
    sizes = []

    def apply(chunk):
        sizes.append(chunk.shape[0])
        return {"x": chunk * 2, "idx": chunk[:, 0].long()}

    out = run_chunked(apply, items, 5)
    assert sizes == [5, 5, 5, 5, 3]  # the last chunk is not padded
    assert torch.equal(out["x"], items * 2) and out["idx"].tolist() == list(range(23))
    host = run_chunked(apply, items, 5, to_host=True)
    assert all(v.device.type == "cpu" for v in host.values())
    assert torch.equal(host["x"], out["x"])
    one = run_chunked(apply, items[:3], 8)
    assert sizes[-1] == 3 and torch.equal(one["x"], items[:3] * 2)


def test_array_frame_io_round_trip(tmp_path):
    io = ArrayFrameIO()
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (13, 17, 3)).astype(np.uint8)
    gray = rng.randint(0, 256, (13, 17)).astype(np.uint8)
    io.imwrite(tmp_path / "00005.jpg", img)
    io.imwrite(tmp_path / "U_00005.jpg", gray)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["00005.jpg", "U_00005.jpg"]
    np.testing.assert_array_equal(io.imread(tmp_path / "00005.jpg"), img)
    np.testing.assert_array_equal(io.imread(str(tmp_path / "U_00005.jpg"), gray=True), gray)
    # As cv2.imread of a gray JPEG in colour; a colour payload is not read in gray.
    np.testing.assert_array_equal(io.imread(tmp_path / "U_00005.jpg"),
                                  cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR))
    with pytest.raises(ValueError):
        io.imread(tmp_path / "00005.jpg", gray=True)
    frames = [rng.randint(0, 256, (9, 11, 3)).astype(np.uint8) for _ in range(4)]
    io.write_video(tmp_path / "M_00001.avi", frames)
    back = io.read_video(tmp_path / "M_00001.avi")
    assert len(back) == 4 and all(np.array_equal(a, b) for a, b in zip(back, frames))
    with pytest.raises(FileNotFoundError):
        io.imread(tmp_path / "missing.jpg")


def test_cv2_frame_io_is_cv2(tmp_path):
    io = Cv2FrameIO()
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (24, 32, 3)).astype(np.uint8)
    io.imwrite(tmp_path / "a.jpg", img)
    assert cv2.imwrite(str(tmp_path / "b.jpg"), img)
    assert (tmp_path / "a.jpg").read_bytes() == (tmp_path / "b.jpg").read_bytes()
    np.testing.assert_array_equal(io.imread(tmp_path / "a.jpg"),
                                  cv2.imread(str(tmp_path / "b.jpg")))
    np.testing.assert_array_equal(io.imread(tmp_path / "a.jpg", gray=True),
                                  cv2.imread(str(tmp_path / "b.jpg"), cv2.IMREAD_GRAYSCALE))
    frames = [rng.randint(0, 60, (24, 32, 3)).astype(np.uint8) for _ in range(5)]
    io.write_video(tmp_path / "M_00001.avi", frames)
    writer = cv2.VideoWriter(str(tmp_path / "M_00002.avi"), cv2.VideoWriter_fourcc(*"MJPG"),
                             10.0, (32, 24))
    for f in frames:
        writer.write(f)
    writer.release()
    cap = cv2.VideoCapture(str(tmp_path / "M_00002.avi"))
    want = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        want.append(f)
    cap.release()
    got = io.read_video(tmp_path / "M_00001.avi")
    assert len(got) == len(want) == 5
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    with pytest.raises(OSError):
        io.imwrite(tmp_path / "no_such_folder" / "x.jpg", img)
    with pytest.raises(FileNotFoundError):
        io.imread(tmp_path / "missing.jpg")


def test_modules_import_without_cv2_and_cv2_io_raises():
    code = (
        "import sys\n"
        "sys.modules['cv2'] = None  # import cv2 now raises ImportError\n"
        "import video_classification_tpu_torch.pipeline.stages\n"
        "import video_classification_tpu_torch.detect.provider\n"
        "import video_classification_tpu_torch.data.fixture\n"
        "import video_classification_tpu_torch.__main__\n"
        "from video_classification_tpu_torch.pipeline.frame_io import ArrayFrameIO, Cv2FrameIO\n"
        "ArrayFrameIO()\n"
        "try:\n"
        "    Cv2FrameIO()\n"
        "except ImportError as e:\n"
        "    assert 'ArrayFrameIO' in str(e), e\n"
        "    print('refused')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "refused"
