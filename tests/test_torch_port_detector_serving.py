"""The detector-serving slice as a whole: the port's Predictor with its
DensePoseOnlineDetector against the JAX package's Predictor with the JAX
DensePoseOnlineDetector, on the same frames and carried weights (CPU,
float32).

The 64x96 fixture and settings of ``test_torch_port_predictor.py`` (depth-18
SlowFast, CLIP_LEN 2, CropLHand, reduced flow); the detector is depth 50
with a 14-pixel chart pooler (56x56 charts), the online budget otherwise
(256 / 64 / 8), on the 128x192 padded frames, in chunks of CLIP_LEN frames.
Detector weights are numpy-seeded with small box-delta layers (boxes stay
near their anchors). The detections are held first, per sampled frame, so a
miss names its stage: valid equal, boxes within 1e-3 px, charts equal on
>= 99.9 % of pixels, U/V within 1e-3 where they agree; then clips uint8
within +-1 on >= 99.9 % and scores within 5e-3, the repo's parity bars.
"""

import functools
import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_classification_tpu.config import get_cfg as jax_get_cfg
from video_classification_tpu.data.fixture import generate_raw_fixture
from video_classification_tpu.engine import Predictor as JaxPredictor
from video_classification_tpu.pipeline import online as jax_online
from video_classification_tpu.pipeline.stages import sample_data
from video_classification_tpu_torch.config import get_cfg
from video_classification_tpu_torch.detect import state_dict_from_jax as detector_from_jax
from video_classification_tpu_torch.engine import Predictor
from video_classification_tpu_torch.models import state_dict_from_jax
from video_classification_tpu_torch.ops.flow import FlowParams
from video_classification_tpu_torch.pipeline.online import (DensePoseOnlineDetector,
                                                            make_online_detector)
from torch_port_support import configure_serving, one_torch_thread  # noqa: F401
from torch_port_support import detector_variables, randomised_variables, read_video

DETECTOR = dict(depth=50, chart_pooler_size=14, batch_size=2)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_detector_serving")
    jcfg = configure_serving(jax_get_cfg(), root)
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    generate_raw_fixture(jcfg, num_videos_per_set=1, num_classes=1,
                         num_frames=34, hw=(64, 96), sets=("train",))
    sample_data(jcfg, sets=("train",))
    m = next(Path(root, "1_Sample").glob("**/M_*.avi"))
    k = Path(str(m).replace("M_", "K_"))
    rgb, depth = read_video(m, gray=False), read_video(k, gray=True)

    jdet = jax_online.DensePoseOnlineDetector(jcfg, allow_random_init=True,
                                              compute_dtype="float32", **DETECTOR)
    shapes = jax.eval_shape(functools.partial(jdet.model.init, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((128, 192, 3)))
    det_vars = detector_variables(shapes, seed=3)
    jdet.variables = jax.tree.map(jnp.asarray, det_vars)
    jax_pred = JaxPredictor(jcfg, detector=jdet)
    variables = randomised_variables(jax.device_get(jax_pred.variables), seed=0)
    jax_pred.variables = jax.tree.map(jnp.asarray, variables)
    orig_decode = jax_online.OnlineVideoDataset._decode
    jax_online.OnlineVideoDataset._decode = lambda self, index: (rgb, depth)
    try:
        jds = jax_pred._dataset(m, k)
        jax_clips = jnp.stack(jds.get_eval_clips(0, random.Random(0), device=True)["clips"])
        jax_scores = np.asarray(jax_pred._eval(jax_pred.variables, jax_clips))
    finally:
        jax_online.OnlineVideoDataset._decode = orig_decode

    cfg = configure_serving(get_cfg(), root)
    cfg.CUDA.COMPUTE_DTYPE = "float32"
    cfg.DATA.ONLINE_DETECTOR = "densepose"
    det = DensePoseOnlineDetector(cfg, state_dict=detector_from_jax(det_vars),
                                  device="cpu", **DETECTOR)
    pred = Predictor(cfg, detector=det, device="cpu",
                     flow_params=FlowParams(n_outer=2, n_sor=4, min_width=16,
                                            fuse_outer_tol=0.0),
                     state_dict=state_dict_from_jax(variables))
    ds = pred.dataset(videos={0: (rgb, depth)})
    clips = torch.stack(ds.get_eval_clips(0, random.Random(0))["clips"]).numpy()
    return {"jax_dets": jds._det_cache[0], "jax_clips": np.asarray(jax_clips),
            "jax_scores": jax_scores, "dets": ds._det_cache[0], "clips": clips,
            "scores": pred.clip_scores_frames(rgb, depth), "det": det}


def _assert_detection_close(got, want, what):
    """(box, valid, chart, uv) of one frame, at the detection bars."""
    box, valid, charts, uv = (np.asarray(t) for t in got)
    wbox, wvalid, wcharts, wuv = (np.asarray(t) for t in want)
    assert charts.shape == wcharts.shape == (56, 56) and uv.shape == (2, 56, 56)
    assert valid == wvalid, what
    np.testing.assert_allclose(box, wbox, atol=1e-3, err_msg=what)
    same = charts == wcharts
    assert same.mean() >= 0.999, (what, same.mean())
    np.testing.assert_allclose(uv[:, same], wuv[:, same], atol=1e-3, err_msg=what)


def test_detections_match_jax(served):
    got, want = served["dets"], served["jax_dets"]
    assert sorted(got) == sorted(want) and len(got) >= 3
    for r in sorted(want):
        _assert_detection_close(got[r], want[r], f"frame {r}")
        box = np.asarray(got[r][0])
        assert 0 <= box[0] <= box[2] <= 192 and 0 <= box[1] <= box[3] <= 128


def test_clips_match_jax(served):
    got, want = served["clips"], served["jax_clips"]
    assert got.shape == want.shape == (2, 2, 64, 64, 21)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert float((diff <= 1).mean()) >= 0.999, (float((diff <= 1).mean()), int(diff.max()))


def test_scores_match_jax(served):
    got, want = served["scores"], served["jax_scores"]
    assert got.shape == want.shape == (2, 3)
    np.testing.assert_allclose(got, want, atol=5e-3)


def test_detector_needs_weights():
    cfg = get_cfg()
    with pytest.raises(ValueError, match="no weights"):
        DensePoseOnlineDetector(cfg, device="cpu", **DETECTOR)
    cfg.DATA.ONLINE_DETECTOR = "densepose"
    with pytest.raises(ValueError, match="no weights"):
        make_online_detector(cfg, "cpu")


def test_detector_runs_in_chunks(served):
    """A chunk size that splits the frames gives the same detections."""
    det = served["det"]
    frames = torch.from_numpy(np.random.RandomState(4).randint(
        0, 256, (3, 128, 192, 3), np.uint8))
    split = det(frames)  # chunks of 2 and 1
    det.batch_size = 3
    try:
        whole = det(frames)
    finally:
        det.batch_size = DETECTOR["batch_size"]
    for i in range(3):
        _assert_detection_close([t[i] for t in split], [t[i] for t in whole],
                                f"frame {i}")
