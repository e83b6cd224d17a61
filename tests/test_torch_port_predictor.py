"""The serving slice as a whole: the port's Predictor against the JAX
package's Predictor on the same frames and the same carried weights (CPU,
float32).

The fixture is a raw M_/K_ .avi pair at 64x96 (so the synthetic detector's
parts clear the 15 px rule), decoded once with cv2; both predictors see
those frames. Depth 18, CLIP_LEN 2, CropLHand, reduced flow (2 outers, 4
sweeps, min width 16). The port runs its plain kernel twins with the flow
early exit off, since the JAX CPU path always runs every outer.
"""

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
from video_classification_tpu_torch.engine import Predictor
from video_classification_tpu_torch.models import state_dict_from_jax
from video_classification_tpu_torch.ops.flow import FlowParams
from video_classification_tpu_torch.pipeline.online import SyntheticOnlineDetector
from torch_port_support import configure_serving, one_torch_thread  # noqa: F401
from torch_port_support import read_video


def _randomised(variables, seed):
    """BN statistics and affine terms drawn from a numpy seed, so the carried
    weights exercise more than identity batch norms."""
    rng = np.random.RandomState(seed)

    def fill(node, coll):
        out = {}
        for k, v in node.items():
            if hasattr(v, "items"):
                out[k] = fill(v, coll)
                continue
            v = np.asarray(v)
            if k == "mean":
                v = rng.normal(0, 0.2, v.shape)
            elif k == "var":
                v = rng.uniform(0.5, 1.5, v.shape)
            elif k == "scale":
                v = rng.normal(1, 0.2, v.shape)
            elif k == "bias":
                v = rng.normal(0, 0.2, v.shape)
            out[k] = v.astype(np.float32)
        return out

    return {c: fill(variables[c], c) for c in ("params", "batch_stats")}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_serving")
    jcfg = configure_serving(jax_get_cfg(), root)
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    generate_raw_fixture(jcfg, num_videos_per_set=1, num_classes=1,
                         num_frames=34, hw=(64, 96), sets=("train",))
    sample_data(jcfg, sets=("train",))
    m = next(Path(root, "1_Sample").glob("**/M_*.avi"))
    k = Path(str(m).replace("M_", "K_"))
    rgb, depth = read_video(m, gray=False), read_video(k, gray=True)

    jax_pred = JaxPredictor(jcfg, detector=jax_online.SyntheticOnlineDetector())
    variables = _randomised(jax.device_get(jax_pred.variables), seed=0)
    jax_pred.variables = jax.tree.map(jnp.asarray, variables)
    orig_decode = jax_online.OnlineVideoDataset._decode
    jax_online.OnlineVideoDataset._decode = lambda self, index: (rgb, depth)
    try:
        jax_clips = np.stack(jax_pred._dataset(m, k).get_eval_clips(
            0, random.Random(0))["clips"])
        jax_scores = jax_pred.clip_scores(m, k)
    finally:
        jax_online.OnlineVideoDataset._decode = orig_decode

    cfg = configure_serving(get_cfg(), root)
    cfg.CUDA.COMPUTE_DTYPE = "float32"
    pred = Predictor(cfg, detector=SyntheticOnlineDetector(), device="cpu",
                     flow_params=FlowParams(n_outer=2, n_sor=4, min_width=16,
                                            fuse_outer_tol=0.0),
                     state_dict=state_dict_from_jax(variables))
    clips = torch.stack(pred.dataset(videos={0: (rgb, depth)}).get_eval_clips(
        0, random.Random(0))["clips"]).numpy()
    return {"jax_clips": jax_clips, "jax_scores": jax_scores, "clips": clips,
            "scores": pred.clip_scores_frames(rgb, depth),
            "file_scores": pred.clip_scores(m, k), "pred": pred,
            "rgb": rgb, "depth": depth}


def test_clips_match_jax(served):
    got, want = served["clips"], served["jax_clips"]
    assert got.shape == want.shape == (2, 2, 64, 64, 21)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert float((diff <= 1).mean()) >= 0.999, (float((diff <= 1).mean()), int(diff.max()))


def test_scores_match_jax(served):
    got, want = served["scores"], served["jax_scores"]
    assert got.shape == want.shape == (2, 3)
    np.testing.assert_allclose(got, want, atol=5e-3)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_file_path_and_frames_agree(served):
    """The lazily-decoding file entry point serves the same scores."""
    np.testing.assert_allclose(served["file_scores"], served["scores"], atol=1e-6)


def test_predict_frames_ranks_mean_scores(served):
    y = served["pred"].predict_frames(served["rgb"], served["depth"], top_k=2)
    probs = served["scores"].mean(0)
    np.testing.assert_allclose(y["probs"], probs, atol=1e-6)
    assert y["clips"] == 2 and len(y["top"]) == 2
    assert y["top"][0] == (int(np.argmax(probs)) + 1, pytest.approx(float(probs.max())))
