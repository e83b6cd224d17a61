"""Data-parallel ranks of the PyTorch port for the CPU tests, on gloo.

``run_ranks`` starts one process per rank with the environment ``torchrun``
sets (``parallel.multihost.launch_ranks``: a free local port, a timeout,
every rank killed if one hangs) and returns their outputs. Run as a script,
``python tests/torch_port_ranks.py <scenario> <out_dir>`` is one rank:

  * ``trainer``: the tiny synthetic slowfast config of ``tiny_cfg``, rank
    r's checkpoints under ``<out_dir>/rank<r>``: the eval on the initial
    weights, one epoch (two steps of the global batch 4), then
    ``Trainer.train()`` for one more epoch with its eval and checkpoint;
    the results go to ``<out_dir>/rank<r>.pt``;
  * ``temporal``: ``conv3d_temporal_sharded`` of numpy-seeded clips and
    weights (the ``temporal_cases``) on this rank's block of frames; the
    blocks go to ``<out_dir>/rank<r>.pt``.
"""

import os
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
GLOBAL_BATCH = 4


def run_ranks(argv, n: int = 2, timeout: float = 150.0, cwd=ROOT):
    """Runs ``argv`` (after the Python executable; or ``argv(rank)``) as
    ``n`` gloo ranks on the CPU through ``parallel.multihost.launch_ranks``
    (a free port; every rank killed and ``TimeoutError`` raised if they do
    not all end within ``timeout`` seconds); returns [(returncode, stdout,
    stderr)] in rank order."""
    from video_classification_tpu_torch.parallel.multihost import launch_ranks

    env = dict(os.environ, PYTHONPATH=str(ROOT), VCT_PLATFORM="cpu", OMP_NUM_THREADS="1")
    return launch_ranks(argv if callable(argv) else (lambda r: argv), n, env=env, cwd=cwd,
                        timeout_s=timeout)


def tiny_cfg(root, debug=False):
    """The port's tiny synthetic slowfast config (depth 18, CropLHand,
    CLIP_LEN 4, 3 classes, 8 train videos of 9 frames, float32, global
    batch 4, one epoch)."""
    from video_classification_tpu_torch.config import get_cfg

    c = get_cfg()
    c.CHALEARN.ROOT = str(root)
    c.CHALEARN.NUM_CLASS = 3
    c.CHALEARN.CLIP_LEN = 4
    c.CHALEARN.BATCH_SIZE = GLOBAL_BATCH
    c.MODEL.NAME = "slowfast-port-dp"
    c.MODEL.R3D_INPUT = "CropLHand"
    c.MODEL.DEPTH = 18
    c.MODEL.MAX_EPOCH = 1
    c.DATA.SYNTHETIC_NUM_VIDEOS = 8
    c.DATA.SYNTHETIC_SEQ_LEN = 9
    c.CUDA.COMPUTE_DTYPE = "float32"
    c.DEBUG = debug
    return c


def trainer_run(cfg):
    """The ``trainer`` scenario on one process (or one rank): a dict of
    numpy results."""
    from video_classification_tpu_torch.engine import Trainer

    t = Trainer(cfg, device="cpu")
    ev0 = t.run_eval()
    step, losses = t.train_step, []

    def recording(*args, **kwargs):
        m = step(*args, **kwargs)
        losses.append(float(m["loss"]))
        return m

    t.train_step = recording
    epoch = t.train_epoch(0)
    state = {k: v.clone() for k, v in t.model.state_dict().items()}
    best = t.train()
    return {"eval": ev0, "epoch": epoch, "losses": losses, "state": state, "best": best,
            "n_processes": t.n_processes}


def temporal_cases():
    """(name, x (N, C, T, H, W), w (Cout, Cin, kt, kh, kw)) float32 numpy."""
    rng = np.random.RandomState(0)
    cases = []
    for kt in (1, 3, 5):
        cases.append((f"kt{kt}", rng.randn(2, 3, 8, 4, 4).astype(np.float32),
                      (rng.randn(5, 3, kt, 1, 1) * 0.1).astype(np.float32)))
    cases.append(("spatial", rng.randn(1, 2, 8, 6, 6).astype(np.float32),
                  (rng.randn(4, 2, 3, 3, 3) * 0.1).astype(np.float32)))
    return cases


def main():
    import torch

    from video_classification_tpu_torch.parallel import conv3d_temporal_sharded
    from video_classification_tpu_torch.parallel.multihost import initialize_distributed
    from video_classification_tpu_torch.parallel.temporal import gather_t, shard_t

    torch.set_num_threads(1)
    scenario, out = sys.argv[1], Path(sys.argv[2])
    assert initialize_distributed(device="cpu", timeout_s=120)
    rank = int(os.environ["RANK"])
    if scenario == "trainer":
        result = trainer_run(tiny_cfg(out / f"rank{rank}"))
    elif scenario == "temporal":
        result = {}
        for name, x, w in temporal_cases():
            xl = shard_t(torch.from_numpy(x))
            y = conv3d_temporal_sharded(xl, torch.from_numpy(w))
            result[name] = {"local": y, "gathered": gather_t(y)}
    else:
        raise SystemExit(f"unknown scenario {scenario!r}")
    torch.save(result, out / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
