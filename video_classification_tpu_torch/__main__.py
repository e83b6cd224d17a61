"""Command-line interface of the PyTorch port.

The JAX package's argument surface (its ``__main__.py``), for the workflows
this package runs:

    python -m video_classification_tpu_torch train slowfast-Torso [...] [--warmstart F]
    python -m video_classification_tpu_torch train-parts
    python -m video_classification_tpu_torch train-parallel slowfast-HTAH slowfast-Torso [--devices-per-stream N]
    python -m video_classification_tpu_torch eval slowfast-HTAH
    python -m video_classification_tpu_torch preprocess --root /data/ChaLearn [--provider synthetic]
    python -m video_classification_tpu_torch sparse-dump
    python -m video_classification_tpu_torch sparse-train
    python -m video_classification_tpu_torch infer M_00001.avi [--depth K_00001.avi] [--ensemble]
    python -m video_classification_tpu_torch v2-convert --root /data/ChaLearn [--provider synthetic]
    python -m video_classification_tpu_torch v2-train [--model slowfast-HTAH]
    python -m video_classification_tpu_torch tools how-many-classes <labels.txt>
    python -m video_classification_tpu_torch tools render-iuv <iuv.pkl> <M_video.avi> <out_dir>

``--opts KEY VALUE ...`` merges dotted config overrides last; ``--root`` is
CHALEARN.ROOT. Everything runs on the CUDA card and raises without one;
``VCT_PLATFORM=cpu`` runs it on the CPU instead (the kernels' plain
versions), the variable the JAX package's CLI reads. ``preprocess``,
``v2-convert``, ``v2-train`` and ``tools render-iuv`` read and write JPEG
and AVI files through ``cv2`` (``Cv2FrameIO``), as the JAX CLI does; their
DensePose provider needs ``--densepose-pkl``, and ``v2-convert
--flow-method raft`` needs ``--raft-checkpoint``.

``train``, ``train-parts``, ``train-parallel`` and ``eval`` first call
``parallel.multihost.initialize_distributed``: under ``torchrun`` (or its
environment: RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) each
process is one data-parallel rank and prints its rank line; without it they
run alone. ``train-parallel`` trains its streams at once, one thread per
device group (``--devices-per-stream``; a group of several cards trains its
stream data-parallel), and refuses to run as one rank of a world.

``bench`` is not ported: the repository's benchmark (the root ``bench.py``
and ``benchmarks/``) is earlier work, and the port's own measurement waits
for the ``benchmark`` PR that writes ``BENCHMARK.json``. It exits with
status 2 and says so.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

# Subcommand (or tool) -> why it is not ported, and what ports it.
NOT_PORTED = {
    "bench": "the port's benchmark comes with the `benchmark` PR that writes "
             "BENCHMARK.json (ROADMAP queue 1, item 1)",
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


def _provider(cmd, kind, densepose_pkl, device):
    if kind == "synthetic":
        from .pipeline.iuv_contract import SyntheticIUVProvider

        return SyntheticIUVProvider()
    from .detect.provider import DensePoseIUVProvider

    if densepose_pkl is None:
        raise SystemExit(f"{cmd} --provider densepose needs --densepose-pkl (a "
                         "detectron2 model_final_*.pkl): a randomly initialised "
                         "detector gives meaningless IUV")
    return DensePoseIUVProvider(weights_pkl=densepose_pkl, device=device)


def _run_preprocess(args, device) -> None:
    from .pipeline import stages
    from .pipeline.frame_io import Cv2FrameIO

    todo = args.stages or stages.FULL_CHAIN
    # Built, and its weights found, before any stage runs.
    provider = (_provider("preprocess", args.provider, args.densepose_pkl, device)
                if {"iuv", "cse"} & set(todo) else None)
    stages.run_stages(_cfg_for("slowfast-HTAH", args), todo, provider, tuple(args.sets),
                      io=Cv2FrameIO(), device=device)


def _run_v2_convert(args, device) -> None:
    from .pipeline.frame_io import Cv2FrameIO
    from .v2 import (ConvertIuvPklToPartBox, ConvertIuvPklToUvVideo, ConvertVideoToFlow,
                     ConvertVideoToIUVPkl)

    if args.flow_method == "raft" and args.raft_checkpoint is None:
        raise SystemExit("v2-convert --flow-method raft needs --raft-checkpoint (a "
                         "torchvision raft_large .pth): random weights give meaningless flow")
    cfg = _cfg_for("slowfast-HTAH", args)
    io = Cv2FrameIO()
    provider = _provider("v2-convert", args.provider, args.densepose_pkl, device)
    ConvertVideoToFlow(cfg, method=args.flow_method, raft_checkpoint=args.raft_checkpoint,
                       io=io, device=device).convert()
    ConvertVideoToIUVPkl(cfg, provider, io=io).convert()
    ConvertIuvPklToUvVideo(cfg, io=io).convert()
    ConvertIuvPklToPartBox(cfg, io=io, device=device).convert()


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
                       help="train streams concurrently, one per device group")
    p.add_argument("models", nargs="+", help="config names, e.g. the 6 streams")
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

    p = sub.add_parser("v2-convert", help="run the v2 video-native converters")
    p.add_argument("--provider", choices=["densepose", "synthetic"], default="densepose")
    p.add_argument("--densepose-pkl", default=None,
                   help="detectron2 pkl for the densepose provider; required by it")
    p.add_argument("--flow-method", choices=["variational", "raft"], default="variational")
    p.add_argument("--raft-checkpoint", default=None,
                   help="torchvision raft_large .pth for --flow-method raft; required by it")
    _add_opts(p)
    p = sub.add_parser("v2-train", help="train the v2 (5,2)-pathway model")
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

    sub.add_parser("bench", help="the throughput benchmark (not ported)")

    p = sub.add_parser("tools")
    tool_sub = p.add_subparsers(dest="tool", required=True)
    t = tool_sub.add_parser("how-many-classes")
    t.add_argument("labels_txt")
    t = tool_sub.add_parser("render-iuv", help="draw an IUV pkl's boxes on a video's frames")
    t.add_argument("iuv_pkl")
    t.add_argument("video")
    t.add_argument("out_dir")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    unported = args.tool if args.cmd == "tools" else args.cmd
    if unported in NOT_PORTED:
        print(f"{' '.join(filter(None, (args.cmd, getattr(args, 'tool', None))))}: not "
              f"ported: {NOT_PORTED[unported]}", file=sys.stderr)
        return 2
    device = _device()
    if args.cmd in ("train", "train-parts", "train-parallel", "eval"):
        # Data parallelism (parallel/multihost): a no-op without the
        # torchrun environment; with it, this process is one rank.
        from .parallel.multihost import initialize_distributed, process_count

        initialize_distributed(device)
        if args.cmd == "train-parallel" and process_count() > 1:
            print("train-parallel starts its own ranks per device group; run it once, "
                  "not as one rank of a world", file=sys.stderr)
            return 2

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
            print(f"{name}: best acc {trainer.train()!r}")
    elif args.cmd == "train-parts":
        from .engine import train_unimportant_parts

        train_unimportant_parts(cfg_base=_cfg_for("slowfast-HTAH", args), device=device)
    elif args.cmd == "train-parallel":
        from .engine import train_streams_parallel

        results = train_streams_parallel(args.models, cfg_overrides=_common_opts(args),
                                         devices_per_stream=args.devices_per_stream,
                                         device=device)
        for name, acc in results.items():
            print(f"{name}: best acc {acc:.4f}")
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
    elif args.cmd == "v2-convert":
        _run_v2_convert(args, device)
    elif args.cmd == "v2-train":
        from .pipeline.frame_io import Cv2FrameIO
        from .v2 import V2Trainer

        V2Trainer(_cfg_for(args.model, args), io=Cv2FrameIO(), device=device).train()
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

        if args.tool == "how-many-classes":
            tools.how_many_classes(Path(args.labels_txt))
        elif args.tool == "render-iuv":
            from .pipeline.frame_io import Cv2FrameIO

            n = tools.render_iuv_boxes(Path(args.iuv_pkl), Path(args.video),
                                       Path(args.out_dir), io=Cv2FrameIO())
            print(f"wrote {n} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
