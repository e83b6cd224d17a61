"""The port's CLI under two gloo ranks (CPU; every process with a timeout of
its own and a free port):

  * ``train`` run as two ranks (the ``torchrun`` environment) runs to the
    end: each rank prints its rank line (gloo) and the same best accuracy,
    and only rank 0 writes checkpoints; ``eval`` as two ranks then restores
    them and both ranks print the same accuracy. (A group of two devices of
    ``train-parallel`` runs these ranks too:
    test_torch_port_parallel_streams.py.)
"""

import re

from torch_port_ranks import run_ranks
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)

OPTS = ["--opts", "CHALEARN.NUM_CLASS", "3", "CHALEARN.CLIP_LEN", "4", "CHALEARN.BATCH_SIZE",
        "6", "MODEL.DEPTH", "18", "MODEL.MAX_EPOCH", "1", "CUDA.COMPUTE_DTYPE", "float32",
        "DATA.SYNTHETIC_NUM_VIDEOS", "6", "DATA.SYNTHETIC_SEQ_LEN", "6"]


def _ckpts(root, name):
    return sorted((root / "logs" / "checkpoints" / name).glob("*.ckpt"))


def test_train_and_eval_as_two_ranks(tmp_path):
    roots = [tmp_path / "rank0", tmp_path / "rank1"]  # a root per rank, to tell writers
    outs = run_ranks(lambda r: ["-m", "video_classification_tpu_torch", "train",
                                "slowfast-LHand", "--root", str(roots[r])] + OPTS)
    accs = []
    for r, (rc, out, err) in enumerate(outs):
        assert rc == 0, err[-3000:]
        assert re.search(rf"distributed: rank {r}/2 .* backend gloo", out), out
        accs.append(re.findall(r"slowfast-LHand: best acc (\S+)", out))
    assert accs[0] == accs[1] and accs[0]
    assert _ckpts(roots[0], "slowfast-LHand") and not _ckpts(roots[1], "slowfast-LHand")

    evals = run_ranks(["-m", "video_classification_tpu_torch", "eval", "slowfast-LHand",
                       "--root", str(roots[0])] + OPTS, n=2)
    said = []
    for rc, out, err in evals:
        assert rc == 0, err[-3000:]
        assert "loading checkpoint" in out
        said.append(re.findall(r"accuracy: (\S+)", out))
    assert said[0] == said[1] and said[0]
