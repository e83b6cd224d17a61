"""Command-line interface of the PyTorch port.

The JAX package's argument surface (its ``__main__.py``), for the workflows
this package runs:

    python -m video_classification_tpu_torch train slowfast-Torso [...] [--warmstart F]
    python -m video_classification_tpu_torch train-parts
    python -m video_classification_tpu_torch eval slowfast-HTAH
    python -m video_classification_tpu_torch preprocess --root /data/ChaLearn [--provider synthetic]
    python -m video_classification_tpu_torch sparse-dump
    python -m video_classification_tpu_torch sparse-train
    python -m video_classification_tpu_torch infer M_00001.avi [--depth K_00001.avi] [--ensemble]
    python -m video_classification_tpu_torch tools how-many-classes <labels.txt>

``--opts KEY VALUE ...`` merges dotted config overrides last; ``--root`` is
CHALEARN.ROOT. Everything runs on the CUDA card and raises without one;
``VCT_PLATFORM=cpu`` runs it on the CPU instead (the kernels' plain
versions), the variable the JAX package's CLI reads. ``preprocess``
reads and writes JPEG and AVI files through ``cv2`` (``Cv2FrameIO``), as the
JAX CLI does; its DensePose provider needs ``--densepose-pkl``.
``train-parallel``, ``v2-convert``, ``v2-train``, ``bench`` and ``tools
render-iuv`` are not ported yet: they exit with status 2, naming the
ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

# Subcommand (or tool) -> the ROADMAP queue-1 item that ports it.
NOT_PORTED = {
    "train-parallel": "11 (parallelism)",
    "v2-convert": "10 (v2 slice)",
    "v2-train": "10 (v2 slice)",
    "bench": "the first benchmark cell (ROADMAP, Open items)",
    "render-iuv": "10 (v2 slice: it reads videos through v2's VideoIO)",
}


def _add_opts(p):
    p.add_argument("--opts", nargs="*", default=[],
                   help="config overrides: KEY VALUE [KEY VALUE ...]")
    p.add_argument("--root", default=None, help="shortcut for CHALEARN.ROOT")


def _common_opts(args):
    opts = list(args.opts)
    if args.root:
        opts = ["CHALEARN.ROOT", args.root] + opts
    return opts


def _cfg_for(name, args):
    from .config import load_model_cfg

    return load_model_cfg(name, overrides=_common_opts(args))


def _device():
    """None (the card) unless VCT_PLATFORM asks for the CPU."""
    plat = os.environ.get("VCT_PLATFORM", "").lower()
    if plat in ("", "cuda", "gpu"):
        return None
    if plat == "cpu":
        return "cpu"
    raise SystemExit(f"VCT_PLATFORM={plat!r}: use 'cpu', 'cuda' or leave it unset")


def _provider(kind, densepose_pkl, device):
    if kind == "synthetic":
        from .pipeline.iuv_contract import SyntheticIUVProvider

        return SyntheticIUVProvider()
    from .detect.provider import DensePoseIUVProvider

    if densepose_pkl is None:
        raise SystemExit("preprocess --provider densepose needs --densepose-pkl (a "
                         "detectron2 model_final_*.pkl): a randomly initialised "
                         "detector gives meaningless IUV")
    return DensePoseIUVProvider(weights_pkl=densepose_pkl, device=device)


def _run_preprocess(args, device) -> None:
    from .pipeline import stages
    from .pipeline.frame_io import Cv2FrameIO

    todo = args.stages or stages.FULL_CHAIN
    # Built, and its weights found, before any stage runs.
    provider = (_provider(args.provider, args.densepose_pkl, device)
                if {"iuv", "cse"} & set(todo) else None)
    stages.run_stages(_cfg_for("slowfast-HTAH", args), todo, provider, tuple(args.sets),
                      io=Cv2FrameIO(), device=device)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="video_classification_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="train one or more model configs in sequence")
    p.add_argument("models", nargs="+", help="config names, e.g. slowfast-Torso")
    p.add_argument("--warmstart", default=None,
                   help="torch .pyth/.ckpt pickle for the tier-3 Kinetics warm start")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace (trace.json) of one epoch to "
                        "DIR before training starts")
    _add_opts(p)

    p = sub.add_parser("train-parts", help="train the 8 extra crop streams")
    _add_opts(p)

    p = sub.add_parser("train-parallel",
                       help="train streams concurrently (not ported yet)")
    p.add_argument("models", nargs="+")
    p.add_argument("--devices-per-stream", type=int, default=1)
    _add_opts(p)

    p = sub.add_parser("eval", help="run uniform-sampling eval for a config")
    p.add_argument("model")
    _add_opts(p)

    p = sub.add_parser("preprocess", help="run the offline preprocessing chain")
    p.add_argument("--stages", nargs="*", default=None,
                   help="subset: sample images flow energy pad iuv cse crop")
    p.add_argument("--sets", nargs="*", default=["train", "test", "valid"])
    p.add_argument("--provider", choices=["densepose", "synthetic"], default="densepose")
    p.add_argument("--densepose-pkl", default=None,
                   help="detectron2 model_final_*.pkl for the densepose provider "
                        "(converted via detect/d2_convert); required by it")
    _add_opts(p)

    p = sub.add_parser("sparse-dump", help="dump per-part eval materials")
    _add_opts(p)
    p = sub.add_parser("sparse-train", help="train the sparse fusion layer")
    _add_opts(p)

    p = sub.add_parser("v2-convert", help="the v2 video-native converters (not ported yet)")
    p.add_argument("--provider", choices=["densepose", "synthetic"], default="densepose")
    p.add_argument("--densepose-pkl", default=None)
    p.add_argument("--flow-method", choices=["variational", "raft"], default="variational")
    p.add_argument("--raft-checkpoint", default=None)
    _add_opts(p)
    p = sub.add_parser("v2-train", help="train the v2 (5,2)-pathway model (not ported yet)")
    p.add_argument("--model", default="slowfast-HTAH")
    _add_opts(p)

    p = sub.add_parser("infer", help="classify a raw gesture video (serving path)")
    p.add_argument("video", help="RGB (M_*) video file")
    p.add_argument("--depth", default=None, help="depth (K_*) video file")
    p.add_argument("--model", default="slowfast-HTAH",
                   help="stream config (ignored with --ensemble)")
    p.add_argument("--ensemble", action="store_true",
                   help="fuse the 5 part streams with the sparse-fusion ckpt")
    p.add_argument("--top-k", type=int, default=5)
    _add_opts(p)

    sub.add_parser("bench", help="the throughput benchmark (not ported yet)")

    p = sub.add_parser("tools")
    tool_sub = p.add_subparsers(dest="tool", required=True)
    t = tool_sub.add_parser("how-many-classes")
    t.add_argument("labels_txt")
    t = tool_sub.add_parser("render-iuv", help="(not ported yet)")
    t.add_argument("iuv_pkl")
    t.add_argument("video")
    t.add_argument("out_dir")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    unported = args.tool if args.cmd == "tools" else args.cmd
    if unported in NOT_PORTED:
        print(f"{' '.join(filter(None, (args.cmd, getattr(args, 'tool', None))))}: not "
              f"ported yet; ROADMAP queue 1, item {NOT_PORTED[unported]}", file=sys.stderr)
        return 2
    device = _device()

    if args.cmd == "train":
        from .engine import Trainer

        warm = Path(args.warmstart) if args.warmstart else None
        for name in args.models:  # sequential multi-config loop (train.py:408-415)
            trainer = Trainer(_cfg_for(name, args), torch_warmstart=warm, device=device)
            if args.profile:
                import torch

                out = Path(args.profile)
                out.mkdir(parents=True, exist_ok=True)
                with torch.profiler.profile() as prof:
                    trainer.train_epoch(0)
                prof.export_chrome_trace(str(out / "trace.json"))
            trainer.train()
    elif args.cmd == "train-parts":
        from .engine import train_unimportant_parts

        train_unimportant_parts(cfg_base=_cfg_for("slowfast-HTAH", args), device=device)
    elif args.cmd == "preprocess":
        _run_preprocess(args, device)
    elif args.cmd == "eval":
        from .engine import Trainer

        y = Trainer(_cfg_for(args.model, args), device=device).run_eval()
        print(f"accuracy: {y['acc']:.4f}")
    elif args.cmd == "sparse-dump":
        from .engine import ResultSaver

        ResultSaver(cfg_overrides=_common_opts(args), device=device).save_network_output()
    elif args.cmd == "sparse-train":
        from .engine import SparseTrainer

        best = SparseTrainer(_cfg_for("slowfast-HTAH", args), device=device).train()
        print(f"best accuracy: {best:.4f}")
    elif args.cmd == "infer":
        if args.ensemble:
            from .engine import EnsemblePredictor

            pred = EnsemblePredictor(cfg_overrides=_common_opts(args), device=device)
        else:
            from .engine import Predictor

            pred = Predictor(_cfg_for(args.model, args), device=device)
        y = pred.predict(args.video, args.depth, top_k=args.top_k)
        print(f"clips scored: {y['clips']}")
        for rank, (label, prob) in enumerate(y["top"], 1):
            print(f"#{rank}: class {label}  p={prob:.4f}")
    elif args.cmd == "tools":
        from . import tools

        tools.how_many_classes(Path(args.labels_txt))
    return 0


if __name__ == "__main__":
    sys.exit(main())
