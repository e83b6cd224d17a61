"""The offline chain: the port's ``pipeline/stages`` against the JAX
package's on the same raw fixture (CPU).

The JAX ``generate_raw_fixture`` writes two 10-frame 48x64 M_/K_ pairs per
set (cv2 MJPG) for train and test; each package runs every stage (sample,
images, flow, energy, pad, IUV with ``SyntheticIUVProvider``, CSE, crop) on
a copy of it through cv2. Flow is small (2 outers, 4 sweeps, min width 16):
the JAX fused level interpreted, the port's fused level on the CPU, both
without the early exit (``fuse_outer_tol`` 0), as
``test_torch_port_flow.py`` compares them.

Held: the same file names in every stage folder; the label files, the
images and the pads byte-equal; the IUV and CSE pickles equal; the flow
stage's uint8 arrays, taken before JPEG encoding, within +-1 on >= 99.9 %;
every crop byte-equal except the flow crops (F0..F4, cut from each
package's own flow JPEGs); each package's ``iuv_to_crop`` on the other's
pickles writes its own crops again; the port's ``filter_img_by_flow`` on
the JAX flow images keeps the JAX frames; skip-if-exists; the port's
``ChalearnVideoDataset`` reads the crops; the port's fixtures give the JAX
fixtures' files.
"""

import pickle
import shutil
from pathlib import Path

import cv2
import numpy as np
import pytest

from video_classification_tpu.config import get_cfg as jax_get_cfg
from video_classification_tpu.data import fixture as jax_fixture
from video_classification_tpu.ops import flow as jflow
from video_classification_tpu.pipeline import stages as jax_stages
from video_classification_tpu.pipeline.iuv_contract import (
    SyntheticIUVProvider as JaxSynthetic)
from video_classification_tpu_torch.config import get_cfg
from video_classification_tpu_torch.data import fixture
from video_classification_tpu_torch.data.dataset import MISSING_FILL, ChalearnVideoDataset
from video_classification_tpu_torch.ops.flow import FlowParams
from video_classification_tpu_torch.pipeline import stages
from video_classification_tpu_torch.pipeline.frame_io import ArrayFrameIO, Cv2FrameIO
from video_classification_tpu_torch.pipeline.iuv_contract import SyntheticIUVProvider
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)

SETS = ("train", "test")
FLOW = dict(n_outer=2, n_sor=4, min_width=16, fuse_outer_tol=0.0)
CROPS = ("CropBody", "CropHTAH", "CropLHand", "CropRHand", "CropLHandArm",
         "CropRHandArm", "CropTorso")


def _cfg(get, root):
    c = get()
    c.CHALEARN.ROOT = str(root)
    c.CHALEARN.SAMPLE_CLASS = 2
    return c


class RecordingIO(Cv2FrameIO):
    """Cv2FrameIO that keeps the flow images it writes."""

    def __init__(self, root):
        super().__init__()
        self.root, self.flow = root, {}

    def imwrite(self, path, img):
        if "2_Flow" in str(path):
            self.flow[Path(path).relative_to(self.root).as_posix()] = img.copy()
        super().imwrite(path, img)


def _run_jax(root):
    cfg = _cfg(jax_get_cfg, root)
    flow, real = {}, cv2.imwrite

    def record(path, img, *a):
        flow[Path(path).relative_to(root).as_posix()] = img.copy()
        return real(path, img, *a)

    provider = JaxSynthetic()
    jax_stages.sample_data(cfg, SETS)
    jax_stages.video_to_images(cfg)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_stages.cv2, "imwrite", record)
    try:
        jax_stages.video_to_flow(cfg, jflow.FlowParams(fuse_level="interpret", **FLOW))
    finally:
        mp.undo()
    jax_stages.filter_img_by_flow(cfg)
    jax_stages.image_to_padded(cfg)
    jax_stages.padded_to_iuv(cfg, provider, sets=SETS)
    jax_stages.padded_to_cse(cfg, provider, sets=SETS)
    jax_stages.iuv_to_crop(cfg, sets=SETS)
    return flow


def _run_port(root):
    cfg = _cfg(get_cfg, root)
    io = RecordingIO(root)
    provider = SyntheticIUVProvider()
    stages.run_full_pipeline(cfg, provider, FlowParams(**FLOW), sets=SETS, io=io,
                             device="cpu")
    stages.filter_img_by_flow(cfg, io=io, device="cpu")
    stages.padded_to_cse(cfg, provider, sets=SETS, io=io)
    return io.flow


def _files(root, top=""):
    base = Path(root, top)
    return sorted(p.relative_to(root).as_posix() for p in base.rglob("*") if p.is_file())


def _pickles(root, stage):
    out = {}
    for pkl in sorted(Path(root, stage).rglob("*.pkl")):
        with pkl.open("rb") as f:
            items = pickle.load(f)
        for item in items:
            item["file_name"] = Path(item["file_name"]).relative_to(root).as_posix()
        out[pkl.relative_to(root).as_posix()] = items
    return out


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    base = tmp_path_factory.mktemp("chains")
    roots = {k: base / k for k in ("jax", "port")}
    jax_fixture.generate_raw_fixture(_cfg(jax_get_cfg, roots["jax"]), num_videos_per_set=2,
                                     num_classes=2, num_frames=10, hw=(48, 64), sets=SETS)
    shutil.copytree(roots["jax"], roots["port"])
    flows = {"jax": _run_jax(roots["jax"]), "port": _run_port(roots["port"])}
    return roots, flows


def test_every_stage_folder_has_the_same_files(chains):
    roots, _ = chains
    files = _files(roots["jax"])
    assert files == _files(roots["port"])
    tops = {f.split("/")[0] for f in files}
    assert tops == {"0_Iso", "1_Sample", "2_Images", "2_Flow", "2_Images_energy", "3_Pad",
                    "4_IUV", "4_CSE", *CROPS}
    for crop in CROPS:  # every stream written, with its companions
        names = {Path(f).name for f in files if f.startswith(crop + "/")}
        assert {"00005.jpg", "F4_00005.jpg", "D_00005.jpg"} <= names, crop
        if crop != "CropBody":
            assert {"U_00005.jpg", "V_00005.jpg"} <= names, crop


@pytest.mark.parametrize("top", ["1_Sample", "2_Images", "3_Pad"])
def test_labels_images_and_pads_are_byte_equal(chains, top):
    roots, _ = chains
    files = _files(roots["jax"], top)
    assert files
    for f in files:
        assert Path(roots["jax"], f).read_bytes() == Path(roots["port"], f).read_bytes(), f


@pytest.mark.parametrize("stage", ["4_IUV", "4_CSE"])
def test_iuv_pickles_are_equal(chains, stage):
    roots, _ = chains
    want, got = _pickles(roots["jax"], stage), _pickles(roots["port"], stage)
    assert sorted(got) == sorted(want) and len(want) == 4
    for name, items in want.items():
        assert len(got[name]) == len(items) == 2
        for g, w in zip(got[name], items):
            assert g["file_name"] == w["file_name"]
            for key in ("pred_boxes_XYXY", "scores"):
                assert g[key].dtype == w[key].dtype and np.array_equal(g[key], w[key])
            for key in ("labels", "uv"):
                a, b = g["pred_densepose"][0][key], w["pred_densepose"][0][key]
                assert type(a) is np.ndarray and a.dtype == b.dtype and np.array_equal(a, b)


def test_flow_arrays_within_one_before_encoding(chains):
    _, flows = chains
    assert sorted(flows["port"]) == sorted(flows["jax"]) and len(flows["jax"]) == 40
    got = np.stack([flows["port"][k] for k in sorted(flows["jax"])]).astype(np.int32)
    want = np.stack([flows["jax"][k] for k in sorted(flows["jax"])]).astype(np.int32)
    assert got.shape == want.shape == (40, 48, 64, 3)
    frac = float((np.abs(got - want) <= 1).mean())
    assert frac >= 0.999, frac


def test_crops_equal_where_their_inputs_are(chains):
    roots, _ = chains
    files = [f for f in _files(roots["jax"]) if f.split("/")[0] in CROPS]
    flow_crops = [f for f in files if Path(f).name.startswith("F")]
    frames = [f for f in files if Path(f).name[0].isdigit()]
    assert len(flow_crops) == 5 * len(frames)  # F0..F4 beside each frame's crop
    for f in files:
        if f not in flow_crops:
            assert Path(roots["jax"], f).read_bytes() == Path(roots["port"], f).read_bytes(), f


def _recrop(roots, tmp_path, run, own, other):
    """Crops of a copy of ``own``'s root whose IUV pickles are ``other``'s."""
    root = tmp_path / f"{own}_reads_{other}"
    shutil.copytree(roots[own], root, ignore=shutil.ignore_patterns("Crop*"))
    shutil.rmtree(root / "CropBody", ignore_errors=True)
    shutil.rmtree(root / "4_IUV")
    shutil.copytree(roots[other] / "4_IUV", root / "4_IUV")
    run(root)
    files = [f for f in _files(roots[own]) if f.split("/")[0] in CROPS]
    assert files == [f for f in _files(root) if f.split("/")[0] in CROPS]
    for f in files:
        assert Path(roots[own], f).read_bytes() == Path(root, f).read_bytes(), f


def test_each_package_crops_from_the_others_pickles(chains, tmp_path):
    roots, _ = chains
    _recrop(roots, tmp_path, lambda r: stages.iuv_to_crop(
        _cfg(get_cfg, r), sets=SETS, io=Cv2FrameIO(), device="cpu"), "port", "jax")
    _recrop(roots, tmp_path, lambda r: jax_stages.iuv_to_crop(
        _cfg(jax_get_cfg, r), sets=SETS), "jax", "port")


def test_energy_filter_keeps_the_jax_frames(chains, tmp_path):
    roots, _ = chains
    root = tmp_path / "energy"
    shutil.copytree(roots["port"], root, ignore=shutil.ignore_patterns("2_Images_energy"))
    shutil.rmtree(root / "2_Flow")
    shutil.copytree(roots["jax"] / "2_Flow", root / "2_Flow")
    stages.filter_img_by_flow(_cfg(get_cfg, root), io=Cv2FrameIO(), device="cpu")
    want = _files(roots["jax"], "2_Images_energy")
    assert len(want) == 4 * 8  # min(T, max(8, int(0.3 T))) of T = 10 per video
    assert _files(root, "2_Images_energy") == want
    for f in want:
        assert Path(root, f).read_bytes() == Path(roots["jax"], f).read_bytes()


def test_existing_outputs_are_skipped(chains, tmp_path):
    roots, _ = chains
    root = tmp_path / "again"
    shutil.copytree(roots["port"], root)
    crop = root / "CropLHand/train/001/M_00001/00005.jpg"
    crop.write_bytes(b"kept")

    class Refuses:
        def detect(self, images, file_names):
            raise AssertionError("an existing IUV pickle was recomputed")

    cfg = _cfg(get_cfg, root)
    stages.padded_to_iuv(cfg, Refuses(), sets=SETS, io=Cv2FrameIO())
    stages.iuv_to_crop(cfg, sets=SETS, io=Cv2FrameIO(), device="cpu")
    assert crop.read_bytes() == b"kept"
    assert _files(root) == _files(roots["port"])


def test_the_port_dataset_reads_the_chains_crops(chains):
    import random

    roots, _ = chains
    cfg = _cfg(get_cfg, roots["port"])
    cfg.MODEL.R3D_INPUT = "CropLHand"
    cfg.CHALEARN.CLIP_LEN = 2
    ds = ChalearnVideoDataset(cfg, "train")
    assert len(ds) == 2
    clips = ds.get_eval_clips(0, random.Random(0))["clips"]
    assert clips[0].shape == (2, 64, 64, 21) and clips[0].dtype == np.uint8
    assert (clips[0] != MISSING_FILL).any()


def test_port_fixtures_give_the_jax_fixtures_files(tmp_path):
    roots = {k: tmp_path / k for k in ("jax", "port", "array", "array_cv2")}
    kw = dict(num_videos_per_set=2, num_classes=2, num_frames=6, hw=(32, 40), sets=SETS,
              seed=3)
    jax_fixture.generate_raw_fixture(_cfg(jax_get_cfg, roots["jax"]), **kw)
    fixture.generate_raw_fixture(_cfg(get_cfg, roots["port"]), **kw)
    fixture.generate_raw_fixture(_cfg(get_cfg, roots["array"]), io=ArrayFrameIO(), **kw)
    files = _files(roots["jax"])
    assert files == _files(roots["port"]) == _files(roots["array"]) and len(files) == 10
    for f in files:
        assert Path(roots["jax"], f).read_bytes() == Path(roots["port"], f).read_bytes(), f
        if f.endswith(".avi"):  # the lossless frames, encoded as JAX does
            target = roots["array_cv2"] / f
            target.parent.mkdir(parents=True, exist_ok=True)
            Cv2FrameIO().write_video(target, ArrayFrameIO().read_video(roots["array"] / f))
            assert target.read_bytes() == Path(roots["jax"], f).read_bytes(), f
    kw = dict(num_videos_per_set=3, num_classes=3, frames_per_video=2,
              crops=("CropLHand", "CropTorso"), seed=4)
    jax_fixture.generate_fixture(_cfg(jax_get_cfg, tmp_path / "jax_crops"), **kw)
    fixture.generate_fixture(_cfg(get_cfg, tmp_path / "port_crops"), **kw)
    files = _files(tmp_path / "jax_crops")
    assert files == _files(tmp_path / "port_crops") and len(files) > 50
    for f in files:
        assert (Path(tmp_path, "jax_crops", f).read_bytes()
                == Path(tmp_path, "port_crops", f).read_bytes()), f
