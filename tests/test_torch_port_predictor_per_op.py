"""The serving slice on the per-op flow path: the port's Predictor against
the JAX package's Predictor, both given ``FlowParams(fuse_level="off")`` (and
then ``n_inner=2``), on the same frames and the same carried weights (CPU,
float32).

The fixture is tests/test_torch_port_predictor.py's: a raw M_/K_ .avi pair
at 64x96 decoded once with cv2, depth 18, CLIP_LEN 2, CropLHand, reduced
flow (2 outers, 4 sweeps, min width 16). The per-op path always runs every
outer, in both packages.
"""

import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_predictor import _randomised
from video_classification_tpu.config import get_cfg as jax_get_cfg
from video_classification_tpu.data.fixture import generate_raw_fixture
from video_classification_tpu.engine import Predictor as JaxPredictor
from video_classification_tpu.ops.flow import FlowParams as JaxFlowParams
from video_classification_tpu.pipeline import online as jax_online
from video_classification_tpu.pipeline.stages import sample_data
from video_classification_tpu_torch.config import get_cfg
from video_classification_tpu_torch.engine import Predictor
from video_classification_tpu_torch.models import state_dict_from_jax
from video_classification_tpu_torch.ops.flow import FlowParams
from video_classification_tpu_torch.pipeline.online import SyntheticOnlineDetector
from torch_port_support import configure_serving, one_torch_thread  # noqa: F401
from torch_port_support import read_video

FLOW = dict(n_outer=2, n_sor=4, min_width=16, fuse_level="off")
ROUTES = {"fuse_level_off": {}, "n_inner_2": {"n_inner": 2}}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_serving_per_op")
    jcfg = configure_serving(jax_get_cfg(), root)
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    generate_raw_fixture(jcfg, num_videos_per_set=1, num_classes=1,
                         num_frames=34, hw=(64, 96), sets=("train",))
    sample_data(jcfg, sets=("train",))
    m = next(Path(root, "1_Sample").glob("**/M_*.avi"))
    k = Path(str(m).replace("M_", "K_"))
    rgb, depth = read_video(m, gray=False), read_video(k, gray=True)

    jax_pred = JaxPredictor(jcfg, detector=jax_online.SyntheticOnlineDetector())
    variables = _randomised(jax.device_get(jax_pred.variables), seed=1)
    jax_pred.variables = jax.tree.map(jnp.asarray, variables)
    cfg = configure_serving(get_cfg(), root)
    cfg.CUDA.COMPUTE_DTYPE = "float32"
    pred = Predictor(cfg, detector=SyntheticOnlineDetector(), device="cpu",
                     state_dict=state_dict_from_jax(variables))

    out = {}
    orig_decode = jax_online.OnlineVideoDataset._decode
    jax_online.OnlineVideoDataset._decode = lambda self, index: (rgb, depth)
    try:
        for route, kw in ROUTES.items():
            jax_pred._flow_params = JaxFlowParams(**FLOW, **kw)
            pred._flow_params = FlowParams(**FLOW, **kw)
            out[route] = {
                "jax_clips": np.stack(jax_pred._dataset(m, k).get_eval_clips(
                    0, random.Random(0))["clips"]),
                "jax_scores": jax_pred.clip_scores(m, k),
                "clips": torch.stack(pred.dataset(videos={0: (rgb, depth)}).get_eval_clips(
                    0, random.Random(0))["clips"]).numpy(),
                "scores": pred.clip_scores_frames(rgb, depth),
            }
    finally:
        jax_online.OnlineVideoDataset._decode = orig_decode
    return out


@pytest.mark.parametrize("route", list(ROUTES))
def test_clips_match_jax(served, route):
    got, want = served[route]["clips"], served[route]["jax_clips"]
    assert got.shape == want.shape == (2, 2, 64, 64, 21)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert float((diff <= 1).mean()) >= 0.999, (float((diff <= 1).mean()), int(diff.max()))


@pytest.mark.parametrize("route", list(ROUTES))
def test_scores_match_jax(served, route):
    got, want = served[route]["scores"], served[route]["jax_scores"]
    assert got.shape == want.shape == (2, 3)
    np.testing.assert_allclose(got, want, atol=5e-3)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_routes_give_other_flow(served):
    """The second inner solve changes the clips' flow channels: the n_inner
    route is not the n_inner 1 route under another name."""
    a = served["fuse_level_off"]["clips"]
    b = served["n_inner_2"]["clips"]
    assert not np.array_equal(a, b)
