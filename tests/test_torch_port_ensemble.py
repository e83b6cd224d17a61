"""The five-stream ensemble of the PyTorch port against the JAX package (CPU,
float32); the ensemble's whole chain in the port is in
test_torch_port_ensemble_chain.py.

  * ``EnsemblePredictor.predict`` of both packages on the same cv2-written
    M_/K_ video pair (64x96, so the synthetic detector's parts clear the
    15 px rule), two part streams at depth 18 (CropLHand and CropRHand,
    CLIP_LEN 2), the synthetic detector and a fast flow (2 outers, 4
    sweeps; the port's early exit off, as the JAX CPU path runs every
    outer), the same numpy-seeded stream weights (carried by
    ``models/convert.state_dict_from_jax``) and fusion parameters: probs
    within 5e-3, the same ``clips``, ``top`` order and ``per_stream`` keys
    (their values within 5e-3), and ``predict_frames`` of the decoded
    frames equal to ``predict`` of the files.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from video_classification_tpu.config import get_cfg as jax_get_cfg
from video_classification_tpu.data.fixture import generate_raw_fixture
from video_classification_tpu.engine.predictor import EnsemblePredictor as JaxEnsemble
from video_classification_tpu.ops.flow import FlowParams as JaxFlowParams
from video_classification_tpu.pipeline import online as jax_online
from video_classification_tpu.pipeline.stages import sample_data
from video_classification_tpu_torch.engine import EnsemblePredictor
from video_classification_tpu_torch.models import state_dict_from_jax
from video_classification_tpu_torch.ops.flow import FlowParams
from video_classification_tpu_torch.pipeline.online import SyntheticOnlineDetector
from torch_port_support import configure_serving, one_torch_thread  # noqa: F401
from torch_port_support import randomised_variables, read_video

STREAMS = ["slowfast-RHand", "slowfast-LHand"]  # unsorted on purpose


def _overrides(root, dtype_key):
    return ["CHALEARN.ROOT", str(root), "CHALEARN.NUM_CLASS", "3", "CHALEARN.CLIP_LEN", "2",
            "CHALEARN.BATCH_SIZE", "2", "MODEL.DEPTH", "18", dtype_key, "float32",
            "DATA.FLOW_OUTER", "2", "DATA.FLOW_SOR", "4", "DATA.FLOW_MIN_WIDTH", "16"]


def write_video(root):
    """A cv2-written 34-frame 64x96 M_/K_ pair under ``root``: (M, K) paths."""
    cfg = configure_serving(jax_get_cfg(), root)
    generate_raw_fixture(cfg, num_videos_per_set=1, num_classes=1, num_frames=34,
                         hw=(64, 96), sets=("train",))
    sample_data(cfg, sets=("train",))
    m = next(Path(root, "1_Sample").glob("**/M_*.avi"))
    return m, Path(str(m).replace("M_", "K_"))


def test_ensemble_predict_matches_jax(tmp_path):
    root = tmp_path
    m, k = write_video(root)
    jens = JaxEnsemble(STREAMS, _overrides(root / "jax", "TPU.COMPUTE_DTYPE"),
                       detector=jax_online.SyntheticOnlineDetector(),
                       flow_params=JaxFlowParams(n_outer=2, n_sor=4, min_width=16))
    ens = EnsemblePredictor(STREAMS, _overrides(root / "port", "CUDA.COMPUTE_DTYPE"),
                            detector=SyntheticOnlineDetector(), device="cpu",
                            flow_params=FlowParams(n_outer=2, n_sor=4, min_width=16,
                                                   fuse_outer_tol=0.0))
    for s, (jp, pp) in enumerate(zip(jens.predictors, ens.predictors)):
        variables = randomised_variables(jax.device_get(jp.variables), seed=20 + s)
        jp.variables = jax.tree.map(jnp.asarray, variables)
        pp.model.load_state_dict(state_dict_from_jax(variables))
    rng = np.random.RandomState(3)
    params = {"weight": rng.normal(1.0, 0.5, size=(3, 2)).astype(np.float32),
              "bias": rng.normal(0.0, 0.2, size=(3,)).astype(np.float32)}
    jens._fusion_params = jax.tree.map(jnp.asarray, params)
    ens._fusion_params = params

    want = jens.predict(str(m), str(k), top_k=3)
    got = ens.predict(m, k, top_k=3)
    assert ens.fusion_source == "given"
    assert got["clips"] == want["clips"] == 2
    np.testing.assert_allclose(got["probs"], want["probs"], atol=5e-3)
    np.testing.assert_allclose(got["probs"].sum(), 1.0, atol=1e-5)
    assert [c for c, _ in got["top"]] == [c for c, _ in want["top"]]
    assert list(got["per_stream"]) == list(want["per_stream"]) == sorted(STREAMS)
    for name in STREAMS:
        assert got["per_stream"][name] == pytest.approx(want["per_stream"][name], abs=5e-3)
    # Decoded frames serve the same request.
    frames = ens.predict_frames(read_video(m, gray=False), read_video(k, gray=True), top_k=3)
    np.testing.assert_allclose(frames["probs"], got["probs"], atol=1e-6)
