"""``ConvertVideoToIUVPkl`` with the DensePose provider against the JAX
package's (CPU, float32, cv2 I/O).

One 5-frame 48x64 M_ video (the JAX raw fixture) through both packages'
converter, each with its ``DensePoseIUVProvider`` at the budget and
weights of ``test_torch_port_provider.py`` (depth 50, numpy-seeded JAX
variables carried by ``detect/convert.state_dict_from_jax``); the frames
are zero-padded to 96x128 by each converter. Per frame the pickles meet
that file's detector bars: boxes within 1e-3 px, scores within 1e-4, and
where the best box's integer corners agree, labels equal on >= 99.9 % and
U, V within 1e-5 where the labels agree. Then the port's UV and box
converters on the JAX pickles write the JAX UV videos and box pickles
exactly (with these random weights no part's largest component reaches 15
px, so every part box is None; test_torch_port_v2_convert.py holds the
boxes of the synthetic provider's charts).
"""

import functools
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np

from video_classification_tpu.config import get_cfg as jax_get_cfg
from video_classification_tpu.data.fixture import generate_raw_fixture as jax_raw_fixture
from video_classification_tpu.detect.provider import DensePoseIUVProvider as JaxProvider
from video_classification_tpu.pipeline import stages as jax_stages
from video_classification_tpu.v2 import convert as jconv
from video_classification_tpu_torch.detect.provider import DensePoseIUVProvider
from video_classification_tpu_torch.pipeline.frame_io import Cv2FrameIO
from video_classification_tpu_torch.profile_preprocess import chain_cfg
from video_classification_tpu_torch.v2 import convert as pconv
from test_torch_port_provider import BUDGET
from torch_port_support import detector_variables, one_torch_thread  # noqa: F401


def _load(path):
    with path.open("rb") as f:
        return pickle.load(f)


def test_densepose_iuv_pickles_match_jax(tmp_path):
    jroot, proot = tmp_path / "jax", tmp_path / "port"
    jcfg = jax_get_cfg()
    jcfg.CHALEARN.ROOT = str(jroot)
    jax_raw_fixture(jcfg, num_videos_per_set=1, num_classes=1, num_frames=5, sets=("train",))
    jax_stages.sample_data(jcfg, ("train",))
    shutil.copytree(jroot, proot)

    jax_provider = JaxProvider(compute_dtype="float32", **BUDGET)
    shapes = jax.eval_shape(functools.partial(jax_provider.model.init, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((120, 160, 3)))
    variables = detector_variables(shapes, seed=5)
    variables["params"]["backbone"]["stem_conv"]["kernel"] *= 0.01
    variables["params"]["box_head"]["cls"]["bias"][0] += 4.0
    jax_provider.variables = jax.tree.map(jnp.asarray, variables)
    jconv.ConvertVideoToIUVPkl(jcfg, jax_provider).convert()
    jconv.ConvertIuvPklToUvVideo(jcfg).convert()
    jconv.ConvertIuvPklToPartBox(jcfg).convert()

    io, pcfg = Cv2FrameIO(), chain_cfg(proot)
    port = DensePoseIUVProvider(variables=variables, device="cpu", **BUDGET)
    pconv.ConvertVideoToIUVPkl(pcfg, port, io=io).convert()

    rel = "train/001/M_00001.pkl"
    want, got = _load(jroot / "4_IUV_New" / rel), _load(proot / "4_IUV_New" / rel)
    assert len(got) == len(want) == 5
    compared = 0
    for g, w in zip(got, want):
        assert g["pred_boxes_XYXY"].shape == w["pred_boxes_XYXY"].shape
        assert w["pred_boxes_XYXY"].shape[0] > 0
        np.testing.assert_allclose(g["pred_boxes_XYXY"], w["pred_boxes_XYXY"], atol=1e-3)
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-4)
        gl, wl = g["pred_densepose"][0]["labels"], w["pred_densepose"][0]["labels"]
        if gl.shape != wl.shape:
            continue  # the best boxes' sizes differ: the charts are not comparable
        compared += 1
        same = gl == wl
        assert same.mean() >= 0.999, same.mean()
        np.testing.assert_allclose(g["pred_densepose"][0]["uv"][:, same],
                                   w["pred_densepose"][0]["uv"][:, same], atol=1e-5)
    assert compared >= 3

    # The port's UV and box converters on the JAX pickles: the JAX files.
    shutil.rmtree(proot / "4_IUV_New")
    shutil.copytree(jroot / "4_IUV_New", proot / "4_IUV_New")
    pconv.ConvertIuvPklToUvVideo(pcfg, io=io).convert()
    pconv.ConvertIuvPklToPartBox(pcfg, io=io, device="cpu").convert()
    for c in (0, 1):
        uv = f"5_UV_Video/train/001/{c}_M_00001.avi"
        assert (proot / uv).read_bytes() == (jroot / uv).read_bytes()
    boxes = _load(proot / "6_Box" / rel)
    assert boxes == _load(jroot / "6_Box" / rel) and len(boxes) == 5
    assert all(len(frame) == 25 for frame in boxes)
