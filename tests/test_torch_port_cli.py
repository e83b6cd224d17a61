"""``python -m video_classification_tpu_torch``: the port's CLI (CPU).

  * ``tools how-many-classes`` prints and returns what the JAX package's
    tool does on the same labels file;
  * on a tiny synthetic root with ``VCT_PLATFORM=cpu`` (depth 18, CLIP_LEN
    4, float32, 6 synthetic videos): ``train`` saves a checkpoint, ``eval``
    restores it, ``sparse-dump`` writes the five part streams' materials,
    ``sparse-train`` fuses them and checkpoints, ``infer --ensemble`` serves
    a video file through the five streams and that checkpoint, and ``infer``
    serves it through one stream;
  * on a tiny raw fixture with ``VCT_PLATFORM=cpu``: ``v2-convert
    --provider synthetic`` writes the four v2 folders, ``v2-train`` trains,
    evaluates and checkpoints, ``tools render-iuv`` writes one image a
    frame; ``v2-convert`` refuses a DensePose provider without
    ``--densepose-pkl`` and RAFT without ``--raft-checkpoint``;
  * without ``VCT_PLATFORM=cpu`` and without a card, a command raises;
  * ``train-parallel`` trains two streams at once on the CPU (one thread
    each), each saving its checkpoint, and prints each stream's accuracy;
  * ``bench``, which the port does not run, exits with status 2 and names
    the ``benchmark`` PR that writes BENCHMARK.json.
"""

import contextlib
import io
from pathlib import Path

import pytest
import torch

from video_classification_tpu import tools as jax_tools
from video_classification_tpu_torch import __main__ as cli
from video_classification_tpu_torch.engine.sparse import PART_YAMLS
from test_torch_port_ensemble import write_video
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)

OPTS = ["--opts", "CHALEARN.NUM_CLASS", "3", "CHALEARN.CLIP_LEN", "4", "CHALEARN.BATCH_SIZE",
        "6", "MODEL.DEPTH", "18", "MODEL.MAX_EPOCH", "1", "CUDA.COMPUTE_DTYPE", "float32",
        "DATA.SYNTHETIC_NUM_VIDEOS", "6", "DATA.SYNTHETIC_SEQ_LEN", "6",
        "DATA.FLOW_OUTER", "1", "DATA.FLOW_SOR", "2", "DATA.FLOW_MIN_WIDTH", "16"]


def _run(argv):
    """(exit status, stdout, stderr) of the CLI run in this process."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_how_many_classes_matches_jax(tmp_path, capsys):
    labels = tmp_path / "train.txt"
    labels.write_text("".join(f"train/{i:03d}/M_{i:05d}.avi train/{i:03d}/K_{i:05d}.avi "
                              f"{(i * 7) % 11 + 3}\n" for i in range(40)))
    want = jax_tools.how_many_classes(labels)
    jax_out = capsys.readouterr().out
    rc, out, _ = _run(["tools", "how-many-classes", str(labels)])
    assert rc == 0 and out == jax_out and out.startswith("3 13 11\n")
    from video_classification_tpu_torch.tools import how_many_classes

    assert how_many_classes(labels) == want


@pytest.fixture(scope="module")
def workflows(tmp_path_factory):
    """train -> eval -> sparse-dump -> sparse-train -> infer on one root."""
    root = tmp_path_factory.mktemp("cli_root")
    mp = pytest.MonkeyPatch()
    mp.setenv("VCT_PLATFORM", "cpu")
    m, k = write_video(tmp_path_factory.mktemp("cli_video"))
    common = ["--root", str(root)] + OPTS
    runs = {}
    try:
        for name, argv in (
                ("train", ["train", "slowfast-LHand"] + common),
                ("eval", ["eval", "slowfast-LHand"] + common),
                ("sparse-dump", ["sparse-dump"] + common),
                ("sparse-train", ["sparse-train"] + common),
                ("ensemble", ["infer", str(m), "--depth", str(k), "--ensemble",
                              "--top-k", "2"] + common),
                ("infer", ["infer", str(m), "--model", "slowfast-LHand"] + common)):
            runs[name] = _run(argv)
    finally:
        mp.undo()
    return root, runs


def test_train_and_eval(workflows):
    root, runs = workflows
    for name in ("train", "eval"):
        assert runs[name][0] == 0, runs[name][2]
    ckpts = list(Path(root, "logs", "checkpoints", "slowfast-LHand").glob("*.ckpt"))
    assert ckpts and "[ckpt_saved]" in runs["train"][1]
    assert "loading checkpoint from" in runs["eval"][1]
    assert "accuracy: " in runs["eval"][1]


def test_sparse_dump_and_train(workflows):
    root, runs = workflows
    assert runs["sparse-dump"][0] == 0 and runs["sparse-train"][0] == 0
    for name_of_set in ("train", "test"):
        folder = Path(root, "logs", "sparse_fusion", name_of_set)
        assert sorted(p.name for p in folder.iterdir()) == sorted(PART_YAMLS)
    assert runs["sparse-train"][1].count("[sparse_test]") == 200  # 2000 epochs / 10
    assert "best accuracy: " in runs["sparse-train"][1]


def test_infer_ensemble_and_single_stream(workflows):
    root, runs = workflows
    rc, out, _ = runs["ensemble"]
    ckpts = sorted(Path(root, "logs", "sparse_fusion_ckpt").iterdir())
    want = f"loading fusion checkpoint {ckpts[-1]}" if ckpts else "uniform mixing"
    assert rc == 0 and want in out
    assert "clips scored: " in out and "#2: class " in out and "#3:" not in out
    rc, out, _ = runs["infer"]
    assert rc == 0 and "#5: class " not in out and "#3: class " in out


def test_a_command_needs_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("VCT_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _run(["eval", "slowfast-LHand", "--root", str(tmp_path)] + OPTS)
    monkeypatch.setenv("VCT_PLATFORM", "tpu")
    with pytest.raises(SystemExit):
        _run(["eval", "slowfast-LHand", "--root", str(tmp_path)] + OPTS)


@pytest.mark.parametrize("argv", [["bench"]])
def test_unported_subcommands_exit_nonzero(argv):
    rc, out, err = _run(argv)
    assert rc == 2 and "not ported" in err and not out
    assert "`benchmark` PR" in err and "BENCHMARK.json" in err
    assert cli.NOT_PORTED.keys() == {"bench"}


def test_train_parallel_trains_each_stream(tmp_path, monkeypatch):
    monkeypatch.setenv("VCT_PLATFORM", "cpu")
    names = ["slowfast-LHand", "slowfast-Torso"]
    rc, out, _ = _run(["train-parallel", *names, "--root", str(tmp_path)] + OPTS)
    assert rc == 0
    for name in names:
        assert f"stream {name}: done" in out and f"{name}: best acc" in out
        assert list((tmp_path / "logs" / "checkpoints" / name).glob("*.ckpt")), name


V2_OPTS = ["--opts", "CHALEARN.NUM_CLASS", "2", "CHALEARN.SAMPLE_CLASS", "2",
           "CHALEARN.CLIP_LEN", "4", "CHALEARN.BATCH_SIZE", "2", "MODEL.DEPTH", "18",
           "MODEL.INPUT_SIZE", "32", "MODEL.MAX_EPOCH", "1", "CUDA.COMPUTE_DTYPE", "float32"]


@pytest.fixture(scope="module")
def v2_workflow(tmp_path_factory):
    """v2-convert -> v2-train -> tools render-iuv on a tiny raw fixture (two
    8-frame 48x64 M_/K_ pairs per set, sampled into 1_Sample), cv2 I/O, on
    the CPU."""
    from video_classification_tpu_torch.config import get_cfg
    from video_classification_tpu_torch.data.fixture import generate_raw_fixture
    from video_classification_tpu_torch.pipeline import stages

    root = tmp_path_factory.mktemp("v2_cli_root")
    cfg = get_cfg()
    cfg.CHALEARN.ROOT = str(root)
    cfg.CHALEARN.SAMPLE_CLASS = 2
    generate_raw_fixture(cfg, num_videos_per_set=2, num_classes=2, num_frames=8,
                         sets=("train", "test"))
    stages.sample_data(cfg, ("train", "test"))
    mp = pytest.MonkeyPatch()
    mp.setenv("VCT_PLATFORM", "cpu")
    common = ["--root", str(root)] + V2_OPTS
    pkl = root / "4_IUV_New" / "train" / "001" / "M_00001.pkl"
    video = root / "1_Sample" / "train" / "001" / "M_00001.avi"
    runs = {}
    try:
        for name, argv in (
                ("v2-convert", ["v2-convert", "--provider", "synthetic"] + common),
                ("v2-train", ["v2-train"] + common),
                ("render-iuv", ["tools", "render-iuv", str(pkl), str(video),
                                str(root / "render")])):
            runs[name] = _run(argv)
    finally:
        mp.undo()
    return root, runs


@pytest.mark.parametrize("name", ["v2-convert", "v2-train", "render-iuv"])
def test_v2_subcommands_run_on_a_tiny_cpu_root(v2_workflow, name):
    """The cases that replaced the three v2 entries of
    test_unported_subcommands_exit_nonzero."""
    import pickle

    root, runs = v2_workflow
    rc, out, err = runs[name]
    assert rc == 0, err
    if name == "v2-convert":
        for video in ("train/001/M_00001", "train/002/M_00002", "test/001/M_00001"):
            for c in (0, 1):
                for base in ("2_Flow_New", "5_UV_Video"):
                    assert (root / base / f"{Path(video).parent}/{c}_{Path(video).name}.avi"
                            ).is_file()
            with (root / "6_Box" / f"{video}.pkl").open("rb") as f:
                boxes = pickle.load(f)
            assert len(boxes) == 8 and all(len(b) == 25 for b in boxes)
            assert (root / "4_IUV_New" / f"{video}.pkl").is_file()
    elif name == "v2-train":
        ckpts = list(Path(root, "logs", "checkpoints", "slowfast-HTAH").glob("*.ckpt"))
        assert ckpts and "[ckpt_saved]" in out and "[eval]" in out
    else:
        assert out == "wrote 8 frames\n"
        assert sorted(p.name for p in (root / "render").iterdir()) == [
            f"{i:05d}.jpg" for i in range(8)]


def test_v2_convert_refuses_to_guess_weights(tmp_path, monkeypatch):
    monkeypatch.setenv("VCT_PLATFORM", "cpu")
    with pytest.raises(SystemExit, match="--densepose-pkl"):
        _run(["v2-convert", "--root", str(tmp_path)])
    with pytest.raises(SystemExit, match="--raft-checkpoint"):
        _run(["v2-convert", "--root", str(tmp_path), "--provider", "synthetic",
              "--flow-method", "raft"])
