"""The port's native clip loader (native/loader.py, its own vcloader.cc)
against the JAX package's (CPU, both libraries loaded in this process):

  * the same JPEG crop fixture (the JAX ``generate_fixture``, one crop frame
    removed): every frame's 21-channel stack bit-equal between the two
    loaders, and a missing frame 127;
  * several clips in flight at once equal to the clips loaded one by one;
  * each package calls its own library (two files, two function addresses);
  * ``DATA.BACKEND auto``: the port's ``ChalearnVideoDataset`` takes the
    native loader, as the JAX one does, and both give the same train and eval
    clips (the cv2 path differs from libjpeg by a few LSB, so this fails
    where the port reads ``auto`` with cv2);
  * without a C++ compiler or without ``jpeglib.h`` (monkeypatched), the
    library is not built, ``native`` raises and ``auto`` reads with cv2;
    the library builds into its own path under ``.torch_ext/native``.
"""

import ctypes
import random
import re
from pathlib import Path

import numpy as np
import pytest

from video_classification_tpu.config import get_cfg as jax_get_cfg
from video_classification_tpu.data import dataset as jds
from video_classification_tpu.data.fixture import generate_fixture as jax_generate_fixture
from video_classification_tpu.native import loader as jloader
from video_classification_tpu_torch.config import get_cfg
from video_classification_tpu_torch.data import dataset as pds
from video_classification_tpu_torch.native import loader as ploader
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)

CROP = "CropLHand"
SIZE = 64


def _cfgs(root, backend="auto"):
    jcfg, cfg = jax_get_cfg(), get_cfg()
    for c in (jcfg, cfg):
        c.CHALEARN.ROOT = str(root)
        c.CHALEARN.NUM_CLASS = 3
        c.CHALEARN.CLIP_LEN = 4
        c.MODEL.R3D_INPUT = CROP
        c.DATA.BACKEND = backend
    return jcfg, cfg


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    if not (jloader.native_available() and ploader.native_available()):
        pytest.skip(f"a native loader does not build: {ploader.build_error()}")
    root = tmp_path_factory.mktemp("native")
    jcfg, _ = _cfgs(root)
    jax_generate_fixture(jcfg, num_videos_per_set=3, num_classes=3, frames_per_video=7)
    missing = sorted((root / CROP / "train").rglob("00010.jpg"))[0]  # a crop lost
    for f in missing.parent.glob("*00010.jpg"):
        f.unlink()
    return root


def _frames(root):
    """Every frame of the fixture's train and test sets, as relative paths."""
    frames = sorted((root / "2_Images").rglob("*.jpg"))
    return [f.relative_to(root / "2_Images") for f in frames]


def test_port_loader_clips_bit_equal_jax(root):
    jl, pl = jloader.NativeClipLoader(2), ploader.NativeClipLoader(2)
    frames = _frames(root)
    assert len(frames) == 42
    n_missing = 0
    for rel in frames:
        paths = ploader.frame_paths_for(root, CROP, rel)
        assert paths == jloader.frame_paths_for(root, CROP, rel)
        got, want = pl.load_clip(paths, 1, SIZE), jl.load_clip(paths, 1, SIZE)
        assert got.shape == (1, SIZE, SIZE, 21) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=str(rel))
        if paths[0] == "":
            n_missing += 1
            assert (got == 127).all()
        else:
            assert (got != 127).any()
    assert n_missing == 1
    assert (pl.load_clip([""] * 18, 2, 32) == 127).all()
    jl.close()
    pl.close()


def test_several_clips_in_flight(root):
    frames = _frames(root)[:6]
    paths = [p for rel in frames for p in ploader.frame_paths_for(root, CROP, rel)]
    loader = ploader.NativeClipLoader(num_threads=4)
    one_by_one = [loader.load_clip(paths[9 * i:], 6 - i, SIZE) for i in range(3)]
    tickets = [loader.submit(paths[9 * i:], 6 - i, SIZE) for i in range(3)]
    tickets += [loader.submit(paths, 6, SIZE) for _ in range(3)]
    outs = {t: None for t in tickets}
    for t in reversed(tickets):  # waited in another order than submitted
        outs[t] = loader.wait(t)
    for i in range(3):
        np.testing.assert_array_equal(outs[tickets[i]], one_by_one[i])
    for t in tickets[3:]:
        np.testing.assert_array_equal(outs[t], one_by_one[0])
    with pytest.raises(ValueError):
        loader.submit(paths[:8], 1, SIZE)
    loader.close()


def test_each_package_calls_its_own_library():
    jlib, plib = jloader.get_lib(), ploader.get_lib()
    assert Path(plib._name) == ploader.SO_PATH and ".torch_ext" in ploader.SO_PATH.parts
    assert Path(jlib._name).resolve() != Path(plib._name).resolve()
    for fn in ("vcl_create", "vcl_submit_clip", "vcl_wait"):
        addr = [ctypes.cast(getattr(lib, fn), ctypes.c_void_p).value for lib in (jlib, plib)]
        assert addr[0] != addr[1], fn


@pytest.mark.parametrize("name_of_set", ["train", "test"])
def test_auto_backend_reads_the_jax_clips(root, name_of_set):
    jcfg, cfg = _cfgs(root, "auto")
    j, p = jds.ChalearnVideoDataset(jcfg, name_of_set), pds.ChalearnVideoDataset(cfg, name_of_set)
    assert j._native is not None and p.decoder == "native"
    assert len(p) == len(j) == 3
    for i in range(len(j)):
        a, b = p.get_train_clip(i, random.Random(i)), j.get_train_clip(i, random.Random(i))
        assert a["label"] == b["label"]
        np.testing.assert_array_equal(a["x"], b["x"])
        a, b = p.get_eval_clips(i, random.Random(7)), j.get_eval_clips(i, random.Random(7))
        assert len(a["clips"]) == len(b["clips"]) > 0
        for x, y in zip(a["clips"], b["clips"]):
            np.testing.assert_array_equal(x, y)
    # The cv2 path is another decoder: its clips differ from these.
    _, cv2_cfg = _cfgs(root, "cv2")
    c = pds.ChalearnVideoDataset(cv2_cfg, name_of_set)
    assert c.decoder == "cv2"
    x = c.get_train_clip(0, random.Random(0))["x"]
    assert not np.array_equal(x, p.get_train_clip(0, random.Random(0))["x"])


@pytest.fixture
def unbuilt(monkeypatch, tmp_path):
    """The port's loader state reset, its library path in a fresh directory."""
    monkeypatch.setattr(ploader, "_lib", None)
    monkeypatch.setattr(ploader, "_build_error", None)
    monkeypatch.setattr(ploader, "SO_PATH", tmp_path / "native" / "libvcloader.so")
    return monkeypatch


@pytest.mark.parametrize("missing", ["compiler", "jpeglib.h"])
def test_native_raises_without_the_toolchain(root, unbuilt, missing):
    if missing == "compiler":
        unbuilt.setattr(ploader, "compiler", lambda: "/nonexistent/g++")
        reason = "no C++ compiler"
    else:
        unbuilt.setattr(ploader, "jpeg_header_found", lambda cxx: False)
        reason = "jpeglib.h is not found"
    assert not ploader.native_available()
    assert reason in ploader.build_error()
    assert not ploader.SO_PATH.exists()
    _, cfg = _cfgs(root, "native")
    with pytest.raises(RuntimeError, match=re.escape(reason)):
        pds.ChalearnVideoDataset(cfg, "train")
    with pytest.raises(RuntimeError, match="unavailable"):
        ploader.NativeClipLoader()
    _, cfg = _cfgs(root, "auto")
    assert pds.ChalearnVideoDataset(cfg, "train").decoder == "cv2"  # JAX's fallback


def test_build_goes_to_its_own_path(unbuilt):
    assert ploader.native_available() and ploader.build_error() is None
    assert ploader.SO_PATH.is_file()
    assert [p.name for p in ploader.SO_PATH.parent.iterdir()] == [ploader.SO_PATH.name]
    name = ploader._so_path().name  # the digest of the source, flags and CPU
    assert name.startswith("libvcloader-") and name == ploader._so_path().name
