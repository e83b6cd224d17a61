"""The ensemble's whole chain in the PyTorch port (CPU, float32, depth 18):
the port's ``Trainer.train()`` for two part streams on synthetic clips,
``ResultSaver`` dumps their eval materials, ``SparseTrainer.train`` fuses
them for 30 epochs and checkpoints on best accuracy, and an
``EnsemblePredictor`` of the two streams (restored through tier 1) serves a
cv2-written video with that checkpoint.
"""

import numpy as np

from video_classification_tpu_torch.config import load_model_cfg
from video_classification_tpu_torch.engine import (EnsemblePredictor, ResultSaver,
                                                   SparseTrainer, Trainer)
from video_classification_tpu_torch.engine.sparse import sparse_dir
from video_classification_tpu_torch.pipeline.online import SyntheticOnlineDetector
from test_torch_port_ensemble import write_video
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)


def _stream_cfg(root, name, crop):
    cfg = load_model_cfg("slowfast-HTAH", ["CHALEARN.ROOT", str(root)])
    cfg.CHALEARN.NUM_CLASS = 3
    cfg.CHALEARN.CLIP_LEN = 4
    cfg.CHALEARN.BATCH_SIZE = 6
    cfg.MODEL.NAME = name
    cfg.MODEL.R3D_INPUT = crop
    cfg.MODEL.DEPTH = 18
    cfg.MODEL.MAX_EPOCH = 1
    cfg.MODEL.LR = 1e-3
    cfg.CUDA.COMPUTE_DTYPE = "float32"
    cfg.DATA.SYNTHETIC_NUM_VIDEOS = 12
    cfg.DATA.SYNTHETIC_SEQ_LEN = 6
    return cfg


def test_train_dump_fuse_serve_chain(tmp_path):
    streams = {"slowfast-LHand": "CropLHand", "slowfast-RHand": "CropRHand"}
    cfgs = {n: _stream_cfg(tmp_path, n, c) for n, c in streams.items()}
    for cfg in cfgs.values():
        assert Trainer(cfg, device="cpu").train() >= 0.0

    class Saver(ResultSaver):
        def load_part_cfgs(self):
            yield from cfgs.values()

    written = Saver(device="cpu").save_network_output()
    assert len(written) == 4 and all(p.exists() for p in written)
    cfg = cfgs["slowfast-LHand"]
    st = SparseTrainer(cfg, batch_size=8, device="cpu")
    assert st.train_dataset.part_names == sorted(streams)
    assert (st.train_dataset.num_part, st.train_dataset.num_class) == (2, 3)
    assert sorted(p.name for p in sparse_dir(cfg, "test").iterdir()) == sorted(streams)
    acc0 = st.test(epoch=0)
    best = st.train(epochs=30)
    assert 0.0 <= acc0 <= best <= 1.0
    ckpts = sorted(st.ckpt_folder.iterdir())
    assert ckpts or best == 0.0

    # The trained streams (tier 1) and the fusion checkpoint serve a video.
    m, k = write_video(tmp_path / "video")
    ens = EnsemblePredictor(list(streams), [
        "CHALEARN.ROOT", str(tmp_path), "CHALEARN.NUM_CLASS", "3", "CHALEARN.CLIP_LEN", "4",
        "MODEL.DEPTH", "18", "CUDA.COMPUTE_DTYPE", "float32", "DATA.FLOW_OUTER", "1",
        "DATA.FLOW_SOR", "2", "DATA.FLOW_MIN_WIDTH", "16"],
        detector=SyntheticOnlineDetector(), device="cpu")
    y = ens.predict(m, k, top_k=2)
    assert ens.fusion_source == (str(ckpts[-1]) if ckpts else "uniform")
    assert y["probs"].shape == (3,) and np.isfinite(y["probs"]).all()
    np.testing.assert_allclose(y["probs"].sum(), 1.0, atol=1e-5)
    assert len(y["top"]) == 2 and y["clips"] >= 1
