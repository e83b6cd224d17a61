"""The v2 converters (``v2/convert.py``) against the JAX package's, on one
raw fixture (CPU, cv2 I/O through ``Cv2FrameIO``).

The JAX ``generate_raw_fixture`` writes two 6-frame 48x64 M_/K_ pairs per
set (train, test) and samples them; each package runs ``v2-convert``'s four
converters on its own copy: the variational flow small (2 outers, 4
sweeps, min width 16, no early exit: the JAX fused level interpreted, the
port's on the CPU), the synthetic provider, the UV videos, the part boxes.

Held: the same file names in every v2 folder; the flow's uint8 arrays,
taken before video encoding, within +-1 on >= 99.9 %; the IUV pickles
equal but for their file names (each package's own root); the UV videos
byte-equal (the same uint8 arrays through the same encoder) and the box
pickles equal; the port's UV and box converters on the JAX pickles write
the JAX files again; skip-if-exists for the IUV pickles and UV videos;
the encoding's truncation. The RAFT method (raft_large from the
synthesized torchvision state_dict, 4 iterations) on a 64x96 video: the
uint8 arrays within +-1 on >= 99.9 %. The DensePose provider's pickles:
test_torch_port_v2_convert_densepose.py.
"""

import pickle
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from video_classification_tpu.config import get_cfg as jax_get_cfg
from video_classification_tpu.data.fixture import generate_raw_fixture as jax_raw_fixture
from video_classification_tpu.models.raft_convert import raft_torch_to_flax
from video_classification_tpu.ops import flow as jflow
from video_classification_tpu.pipeline import stages as jax_stages
from video_classification_tpu.pipeline.iuv_contract import (
    SyntheticIUVProvider as JaxSynthetic)
from video_classification_tpu.v2 import convert as jconv
from video_classification_tpu_torch.models.raft_convert import (synthesize_raft_state_dict,
                                                                write_synthesized_checkpoint)
from video_classification_tpu_torch.ops.flow import FlowParams
from video_classification_tpu_torch.pipeline.frame_io import Cv2FrameIO
from video_classification_tpu_torch.pipeline.iuv_contract import SyntheticIUVProvider
from video_classification_tpu_torch.profile_preprocess import chain_cfg
from video_classification_tpu_torch.v2 import convert as pconv
from video_classification_tpu_torch.v2.convert import encode_flow_v2
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)

SETS = ("train", "test")
FLOW = dict(n_outer=2, n_sor=4, min_width=16, fuse_outer_tol=0.0)
V2_FOLDERS = ("2_Flow_New", "4_IUV_New", "5_UV_Video", "6_Box")


def _jax_cfg(root):
    c = jax_get_cfg()
    c.CHALEARN.ROOT = str(root)
    c.CHALEARN.SAMPLE_CLASS = 2
    return c


def _port_cfg(root):
    c = chain_cfg(root)
    c.CHALEARN.SAMPLE_CLASS = 2
    return c


class RecordingFlow(pconv.ConvertVideoToFlow):
    """The port's flow converter, keeping each video's uint8 flow."""

    def flow_from_frames(self, frames):
        out = super().flow_from_frames(frames)
        self.arrays = getattr(self, "arrays", []) + [out]
        return out


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("v2_convert")
    jroot, proot = base / "jax", base / "port"
    jcfg = _jax_cfg(jroot)
    jax_raw_fixture(jcfg, num_videos_per_set=2, num_classes=2, num_frames=6, sets=SETS)
    jax_stages.sample_data(jcfg, SETS)
    shutil.copytree(jroot, proot)

    jflow_conv = jconv.ConvertVideoToFlow(jcfg, jflow.FlowParams(fuse_level="interpret",
                                                                 **FLOW))
    avis = jconv._sample_m_videos(jcfg)
    jax_arrays = [jflow_conv._flow_from_file(a) for a in avis]
    jflow_conv.convert()
    jconv.ConvertVideoToIUVPkl(jcfg, JaxSynthetic()).convert()
    jconv.ConvertIuvPklToUvVideo(jcfg).convert()
    jconv.ConvertIuvPklToPartBox(jcfg).convert()

    io, pcfg = Cv2FrameIO(), _port_cfg(proot)
    flow = RecordingFlow(pcfg, FlowParams(**FLOW), io=io, device="cpu")
    flow.convert()
    pconv.ConvertVideoToIUVPkl(pcfg, SyntheticIUVProvider(), io=io).convert()
    pconv.ConvertIuvPklToUvVideo(pcfg, io=io).convert()
    pconv.ConvertIuvPklToPartBox(pcfg, io=io, device="cpu").convert()
    return jroot, proot, jax_arrays, flow.arrays


def _files(root, folder):
    return sorted(p.relative_to(root).as_posix() for p in (root / folder).rglob("*")
                  if p.is_file())


def _load(path):
    with path.open("rb") as f:
        return pickle.load(f)


def test_the_same_files(roots):
    jroot, proot = roots[:2]
    for folder in V2_FOLDERS:
        assert _files(proot, folder) == _files(jroot, folder) and _files(jroot, folder), folder
    assert len(_files(jroot, "2_Flow_New")) == 8  # 4 videos x 2 channels


def test_flow_arrays_within_one(roots):
    jax_arrays, port_arrays = roots[2], roots[3]
    assert len(jax_arrays) == len(port_arrays) == 4
    for j, p in zip(jax_arrays, port_arrays):
        assert p.shape == j.shape == (5, 2, 48, 64) and p.dtype == j.dtype == np.uint8
        frac = float(np.mean(np.abs(p.astype(int) - j.astype(int)) <= 1))
        assert frac >= 0.999, frac


def test_iuv_pickles_equal_but_their_file_names(roots):
    jroot, proot = roots[:2]
    for rel in _files(jroot, "4_IUV_New"):
        want, got = _load(jroot / rel), _load(proot / rel)
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            assert g["file_name"] == str(proot / "1_Sample" / Path(rel).relative_to(
                "4_IUV_New").with_suffix(".avi"))
            for k in ("pred_boxes_XYXY", "scores"):
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
            for k in ("labels", "uv"):
                a, b = g["pred_densepose"][0][k], w["pred_densepose"][0][k]
                assert a.dtype == b.dtype and np.array_equal(a, b), k


def test_uv_videos_and_box_pickles_are_exact(roots):
    jroot, proot = roots[:2]
    for rel in _files(jroot, "5_UV_Video"):
        assert (proot / rel).read_bytes() == (jroot / rel).read_bytes(), rel
    for rel in _files(jroot, "6_Box"):
        got, want = _load(proot / rel), _load(jroot / rel)
        assert got == want and len(got) == 6 and all(len(b) == 25 for b in got)
        assert got[0][1] is not None  # the synthetic layout's torso


def test_port_uv_and_boxes_on_the_jax_pickles(roots, tmp_path):
    """The port's converters on the JAX pickles write the JAX files again."""
    jroot = roots[0]
    root = tmp_path / "cross"
    for folder in ("1_Sample", "4_IUV_New"):
        shutil.copytree(jroot / folder, root / folder)
    io, cfg = Cv2FrameIO(), _port_cfg(root)
    pconv.ConvertIuvPklToUvVideo(cfg, io=io).convert()
    pconv.ConvertIuvPklToPartBox(cfg, io=io, device="cpu").convert()
    for rel in _files(jroot, "5_UV_Video"):
        assert (root / rel).read_bytes() == (jroot / rel).read_bytes(), rel
    for rel in _files(jroot, "6_Box"):
        assert _load(root / rel) == _load(jroot / rel), rel


def test_skip_if_exists(roots):
    proot = roots[1]
    io, cfg = Cv2FrameIO(), _port_cfg(proot)
    pkl = proot / _files(proot, "4_IUV_New")[0]
    uv = proot / _files(proot, "5_UV_Video")[0]
    stamps = (pkl.stat().st_mtime_ns, uv.stat().st_mtime_ns)

    class Refuses:
        def detect(self, *a):
            raise AssertionError("an existing IUV pickle was recomputed")

    pconv.ConvertVideoToIUVPkl(cfg, Refuses(), io=io).convert()
    pconv.ConvertIuvPklToUvVideo(cfg, io=io).convert()
    assert (pkl.stat().st_mtime_ns, uv.stat().st_mtime_ns) == stamps


def test_encoding_truncates_as_jax():
    flow = np.asarray([-40.0, -30.0, -0.1176, 0.0, 0.1177, 29.999, 30.0, 55.0,
                       -12.345678, 7.0588236], np.float32)
    want = np.clip(flow, -30, 30) / 60 + 0.5  # the JAX converter's encoding
    want = np.clip(want * 255, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(encode_flow_v2(torch.from_numpy(flow)).numpy(), want)


def test_raft_method_matches_jax(tmp_path):
    from video_classification_tpu_torch.data.fixture import generate_raw_fixture
    from video_classification_tpu_torch.pipeline import stages

    io, cfg = Cv2FrameIO(), _port_cfg(tmp_path)
    generate_raw_fixture(cfg, num_videos_per_set=1, num_classes=1, num_frames=3,
                         hw=(64, 90), sets=("train",), io=io)
    stages.sample_data(cfg, ("train",))
    (avi,) = pconv._sample_m_videos(cfg)
    jcfg = _jax_cfg(tmp_path)
    jax_conv = jconv.ConvertVideoToFlow(jcfg, method="raft", raft_iters=4,
                                        raft_variables=raft_torch_to_flax(
                                            synthesize_raft_state_dict(2)))
    want = jax_conv._flow_from_file(avi)
    port = pconv.ConvertVideoToFlow(cfg, method="raft", raft_iters=4, io=io, device="cpu",
                                    raft_checkpoint=write_synthesized_checkpoint(
                                        tmp_path / "raft.pth", seed=2))
    got = port.flow_from_frames(np.stack(io.read_video(avi)))
    assert got.shape == want.shape == (2, 2, 64, 90)  # reflect-padded to 64x96, cropped
    frac = float(np.mean(np.abs(got.astype(int) - want.astype(int)) <= 1))
    assert frac >= 0.999, frac
    assert len(np.unique(want)) > 10  # the flow is not clipped flat
    with pytest.raises(ValueError, match="raft_checkpoint"):
        pconv.ConvertVideoToFlow(cfg, method="raft", io=io, device="cpu")
