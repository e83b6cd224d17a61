"""Offline preprocessing stages.

Port of the JAX package's ``pipeline/stages.py``: the reference's stage
scripts (``chalearn_*.py``, run by ``run_data_preprocess.sh``) as functions
over the same on-disk stage-folder layout, with the compute-bound loops on
the device:

  stage                reference                       here
  -------------------  ------------------------------  -----------------------------
  sample_data          chalearn_sample_data.py         host copy
  video_to_images      chalearn_video_to_images.py     host decode and write
  video_to_flow        chalearn_video_to_flow.py       ops.flow on the device, in
                       (pyflow C++ + Pool(18))         chunks of a video (K1)
  filter_img_by_flow   chalearn_filter_img_by_flow     ops.flow.flow_energy_filter
  image_to_padded      chalearn_image_to_padded.py     host pad
  padded_to_iuv / cse  detectron2 DensePose            an IUVProvider
  iuv_to_crop          cv2.findContours chain          ops.components on the
                                                       device (K2), host crops

Every file goes through ``io`` (``pipeline/frame_io``: ``Cv2FrameIO``, the
default, or ``ArrayFrameIO``); the device work runs on ``device``, the card
unless the caller passes ``device="cpu"``. The IUV pickles hold plain numpy
values and strings, so either package's crop stage reads the other's.

The reference's idempotence conventions stay: skip-if-exists for IUV dumps
(chalearn_padded_to_iuv.py:38-40) and crop files
(chalearn_iuv_to_crop.py:111-112), full rebuilds elsewhere.
"""

from __future__ import annotations

import pickle
import shutil
from contextlib import nullcontext
from glob import glob
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config.crop_cfg import crop_part_args
from ..ops.components import largest_component_bbox, part_mask
from ..ops.flow import DEFAULT_PARAMS, FlowParams, flow_energy_filter, video_flow_uint8
from ..utils.cuda import resolve_device
from ..utils.labels import SETS, parse_label_lines, write_labels
from .frame_io import Cv2FrameIO
from .iuv_contract import IUVDetection, IUVProvider


def _io(io):
    return Cv2FrameIO() if io is None else io


# -- stage 1: class-filtered sample ---------------------------------------------------


def sample_data(cfg, sets: Sequence[str] = SETS) -> None:
    """Filter labels to l <= SAMPLE_CLASS and copy the .avi pairs into 1_Sample
    (chalearn_sample_data.py:19-66)."""
    iso_root = Path(cfg.CHALEARN.ROOT, cfg.CHALEARN.ISO)
    sample_root = Path(cfg.CHALEARN.ROOT, cfg.CHALEARN.SAMPLE)
    allow = int(cfg.CHALEARN.SAMPLE_CLASS)
    for name_of_set in sets:
        txt = iso_root / "IsoGD_labels" / f"{name_of_set}.txt"
        with txt.open() as f:
            labels = parse_label_lines(f.readlines())
        labels = [(m, k, l) for (m, k, l) in labels if l <= allow]
        write_labels(cfg, name_of_set, labels)
        # Label entries carry the '<set>/xxx/...' prefix already
        # (chalearn_sample_data.py:38-45).
        for m, k, _ in labels:
            for rel in (m, k):
                dst = sample_root / rel
                if dst.exists():
                    continue
                dst.parent.mkdir(parents=True, exist_ok=True)
                shutil.copy(iso_root / name_of_set / rel, dst)


# -- stage 2a: frames -----------------------------------------------------------------


def _sample_videos(cfg) -> List[Path]:
    sample_root = Path(cfg.CHALEARN.ROOT, cfg.CHALEARN.SAMPLE)
    return [Path(p) for p in sorted(glob(str(sample_root / "**" / "*.avi"), recursive=True))]


def _rel_parts(video: Path):
    """(set, xxx, stem) from .../<set>/<xxx>/M_xxxxx.avi."""
    return video.parent.parent.name, video.parent.name, video.stem


def video_to_images(cfg, io=None) -> None:
    """Every IMG_SAMPLE_INTERVAL-th frame as %05d.jpg (chalearn_video_to_images.py)."""
    io = _io(io)
    img_root = Path(cfg.CHALEARN.ROOT, cfg.CHALEARN.IMG)
    interval = int(cfg.CHALEARN.IMG_SAMPLE_INTERVAL)
    for video in _sample_videos(cfg):
        name_of_set, xxx, stem = _rel_parts(video)
        folder = img_root / name_of_set / xxx / stem
        folder.mkdir(parents=True, exist_ok=True)
        for num, frame in enumerate(io.read_video(video)):
            if num % interval == 0:
                io.imwrite(folder / f"{num:05d}.jpg", frame)


# -- stage 2b: optical flow -----------------------------------------------------------


def video_flow_images(frames: np.ndarray, flow_params: FlowParams = DEFAULT_PARAMS,
                      chunk: int = 64, device=None) -> np.ndarray:
    """(T, H, W, 3) uint8 frames -> (T, H, W, 3) uint8 flow images, frame t
    against t-1 and frame 0 against itself, in device calls of ``chunk``
    pairs: each chunk after the first starts one frame early, so that pair
    (start-1, start) is computed inside it, and drops that duplicated first
    output (the JAX stage's loop, stages.py:139-149)."""
    dev = resolve_device(device)
    outs = []
    for start in range(0, len(frames), chunk):
        lo = max(0, start - 1)
        piece = torch.from_numpy(np.ascontiguousarray(frames[lo:start + chunk])).to(dev)
        piece = video_flow_uint8(piece, flow_params).cpu().numpy()
        outs.append(piece if start == 0 else piece[1:])
    flow = np.concatenate(outs, axis=0)
    if flow.shape[0] != len(frames):  # count parity (chalearn_video_to_flow.py:76)
        raise AssertionError(f"{flow.shape[0]} flow images for {len(frames)} frames")
    return flow


def video_to_flow(cfg, flow_params: FlowParams = DEFAULT_PARAMS, chunk: int = 64,
                  rgb_only: bool = True, io=None, device=None) -> None:
    """Per-frame flow images of every M_ video (chalearn_video_to_flow.py).

    The reference's pyflow over a Pool(18) becomes one batched device call
    per chunk of frames (``video_flow_images``)."""
    io = _io(io)
    flow_root = Path(cfg.CHALEARN.ROOT, cfg.CHALEARN.FLOW)
    for video in _sample_videos(cfg):
        if rgb_only and not video.name.startswith("M_"):
            continue
        name_of_set, xxx, stem = _rel_parts(video)
        folder = flow_root / name_of_set / xxx / stem
        folder.mkdir(parents=True, exist_ok=True)
        frames = io.read_video(video)
        if not frames:
            continue
        flow = video_flow_images(np.stack(frames), flow_params, chunk, device)
        for num in range(flow.shape[0]):
            io.imwrite(folder / f"{num:05d}.jpg", flow[num])


def filter_img_by_flow(cfg, keep_fraction: float = 0.3, min_keep: int = 8, io=None,
                       device=None) -> None:
    """Keep the top-energy frames per video -> 2_Images_energy
    (chalearn_filter_img_by_flow.py:43-80)."""
    io = _io(io)
    dev = resolve_device(device)
    flow_root = Path(cfg.CHALEARN.ROOT, cfg.CHALEARN.FLOW)
    energy_root = Path(cfg.CHALEARN.ROOT, cfg.CHALEARN.IMG_ENERGY)
    for video in _sample_videos(cfg):
        if not video.name.startswith("M_"):
            continue
        name_of_set, xxx, stem = _rel_parts(video)
        flow_files = sorted(glob(str(flow_root / name_of_set / xxx / stem / "*.jpg")))
        if not flow_files:
            continue
        flows = torch.from_numpy(np.stack([io.imread(f) for f in flow_files])).to(dev)
        keep_idx, _ = flow_energy_filter(flows, keep_fraction, min_keep)
        keep_nums = {int(Path(flow_files[i]).stem) for i in keep_idx.tolist()}
        target = energy_root / name_of_set / xxx / stem
        target.mkdir(parents=True, exist_ok=True)
        for num, frame in enumerate(io.read_video(video)):
            if num in keep_nums:
                io.imwrite(target / f"{num:05d}.jpg", frame)


# -- stage 3: 2x padding --------------------------------------------------------------


def pad2x(frame: np.ndarray) -> np.ndarray:
    """Centre an (h, w, ...) frame in a zero (2h, 2w, ...) canvas."""
    h, w = frame.shape[:2]
    canvas = np.zeros((2 * h, 2 * w) + frame.shape[2:], frame.dtype)
    canvas[h // 2:h // 2 + h, w // 2:w // 2 + w] = frame
    return canvas


def image_to_padded(cfg, io=None) -> None:
    """Every 2_Images frame centred in a 2H x 2W zero canvas -> 3_Pad
    (chalearn_image_to_padded.py:16-22), M_ and K_ alike."""
    io = _io(io)
    img_root = Path(cfg.CHALEARN.ROOT, cfg.CHALEARN.IMG)
    pad_root = Path(cfg.CHALEARN.ROOT, cfg.CHALEARN.PAD)
    for img in sorted(glob(str(img_root / "**" / "*.jpg"), recursive=True)):
        target = pad_root / Path(img).relative_to(img_root)
        target.parent.mkdir(parents=True, exist_ok=True)
        io.imwrite(target, pad2x(io.imread(img)))


# -- stage 4: IUV detection -----------------------------------------------------------


def _iuv_to_dict(det: IUVDetection) -> dict:
    """The reference's pkl schema (chalearn_iuv_to_crop.py:105-106,207-213),
    numpy-valued."""
    return {
        "file_name": det.file_name,
        "pred_boxes_XYXY": np.asarray(det.boxes_xyxy),
        "scores": np.asarray(det.scores),
        "pred_densepose": [{"labels": np.asarray(det.labels), "uv": np.asarray(det.uv)}],
    }


def padded_to_iuv(cfg, provider: IUVProvider, stage_key: str = "IUV",
                  sets: Sequence[str] = SETS, io=None) -> None:
    """Detect on every padded M_ frame; one pkl per class folder
    (chalearn_padded_to_iuv.py:31-45); skip-if-exists (:38-40). Frames of one
    shape go to the provider together."""
    io = _io(io)
    pad_root = Path(cfg.CHALEARN.ROOT, cfg.CHALEARN.PAD)
    iuv_root = Path(cfg.CHALEARN.ROOT, cfg.CHALEARN[stage_key])
    for name_of_set in sets:
        for class_dir in sorted((pad_root / name_of_set).glob("*")):
            out = iuv_root / name_of_set / f"{class_dir.name}.pkl"
            if out.exists():
                continue
            by_shape: dict = {}
            for img in sorted(class_dir.glob("M_*/*.jpg")):
                frame = io.imread(img)
                by_shape.setdefault(frame.shape, []).append((frame, str(img)))
            if not by_shape:
                continue
            results = []
            for group in by_shape.values():
                dets = provider.detect(np.stack([g[0] for g in group]), [g[1] for g in group])
                results.extend(_iuv_to_dict(d) for d in dets)
            out.parent.mkdir(parents=True, exist_ok=True)
            with out.open("wb") as f:
                pickle.dump(results, f)


def padded_to_cse(cfg, provider: IUVProvider, sets: Sequence[str] = SETS, io=None) -> None:
    """The CSE variant -> 4_CSE (produced, never consumed downstream, as
    chalearn_padded_to_cse.py)."""
    padded_to_iuv(cfg, provider, stage_key="CSE", sets=sets, io=io)


# -- stage 5: part crops --------------------------------------------------------------


def _load_flow_stack(cfg, body_img_path: Path, io) -> np.ndarray:
    """The flow frames covering a sampled frame's interval
    (chalearn_iuv_to_crop.py:25-59): img_num-interval+1 .. img_num, clamped at 0."""
    interval = int(cfg.CHALEARN.IMG_SAMPLE_INTERVAL)
    img_num = int(body_img_path.stem)
    nums = [max(i, 0) for i in range(img_num - interval + 1, img_num + 1)]
    name_of_set, xxx, m_folder = body_img_path.parent.parts[-3:]
    base = Path(cfg.CHALEARN.ROOT, cfg.CHALEARN.FLOW, name_of_set, xxx, m_folder)
    stack = []
    for n in nums:
        p = base / f"{n:05d}.jpg"
        if not p.exists():
            raise FileNotFoundError(f"image has RGB but no flow: {body_img_path} -> {p}")
        stack.append(io.imread(p))
    return np.stack(stack)  # (interval, H, W, 3)


def _crop_write(io, img: np.ndarray, x: int, y: int, w: int, h: int, path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    io.imwrite(path, img[y:y + h, x:x + w])


def part_boxes(labels: np.ndarray, parts, device) -> tuple:
    """(bboxes (P, 4) xywh, valid (P,)) of the largest component of each part
    group's mask of a chart, on the device: K2 on P masks of the box's size
    (chalearn_iuv_to_crop.py:114-149)."""
    charts = torch.from_numpy(np.ascontiguousarray(labels)).to(device)
    masks = torch.stack([part_mask(charts, idxs) for idxs, _ in parts])
    bboxes, valid = largest_component_bbox(masks)
    return bboxes.cpu().numpy(), valid.cpu().numpy()


def iuv_to_crop(cfg, sets: Sequence[str] = SETS, parts: Optional[List] = None,
                io=None, device=None) -> None:
    """Body and part crops from the IUV dumps (chalearn_iuv_to_crop.py:61-242).

    Per frame: the argmax-score box -> CropBody RGB, five padded flow crops
    and a depth crop; then per part group the chart's mask -> its largest
    component's bbox (``part_boxes``, every group at once) -> part RGB, U,
    V, F0..F4 and D crops."""
    io = _io(io)
    dev = resolve_device(device)
    parts = parts if parts is not None else crop_part_args
    interval = int(cfg.CHALEARN.IMG_SAMPLE_INTERVAL)
    pad_root = Path(cfg.CHALEARN.ROOT, cfg.CHALEARN.PAD)
    iuv_root = Path(cfg.CHALEARN.ROOT, cfg.CHALEARN.IUV)
    crop_body_root = Path(cfg.CHALEARN.ROOT, cfg.CHALEARN.CROP_BODY)

    for name_of_set in sets:
        for pkl_path in sorted((iuv_root / name_of_set).glob("*.pkl")):
            with pkl_path.open("rb") as f:
                iuv_res = pickle.load(f)
            for item in iuv_res:
                file_path = Path(item["file_name"])
                x_img, x5 = file_path.name, file_path.parent.name
                if "K_" in x5:
                    continue  # depth frames never carry IUV (:195-197)
                nsetx3x5img = Path(name_of_set, pkl_path.stem, x5, x_img)
                pad_img_path = pad_root / nsetx3x5img
                crop_img_path = crop_body_root / nsetx3x5img
                if item["pred_boxes_XYXY"].shape[0] == 0:
                    print(f"No box detection: {pad_img_path}")
                    continue
                best = int(np.argmax(item["scores"]))
                bx1, by1, bx2, by2 = item["pred_boxes_XYXY"][best].astype(int)
                if bx2 - bx1 < 1 or by2 - by1 < 1:
                    print(f"Degenerate box detection: {pad_img_path}")
                    continue
                box = (bx1, by1, bx2 - bx1, by2 - by1)

                # -- body crop and its companions (crop_body, :61-94)
                img = io.imread(pad_img_path)
                _crop_write(io, img, *box, crop_img_path)
                flow = _load_flow_stack(cfg, pad_img_path, io)
                for i in range(flow.shape[0]):
                    _crop_write(io, pad2x(flow[i]), *box,
                                crop_img_path.parent / f"F{i}_{crop_img_path.name}")
                depth = io.imread(pad_img_path.parent.parent / x5.replace("M_", "K_") / x_img)
                _crop_write(io, depth, *box, crop_img_path.parent / f"D_{crop_img_path.name}")

                # -- part crops (crop_body_parts, :98-183)
                labels = np.asarray(item["pred_densepose"][0]["labels"])
                uv = np.asarray(item["pred_densepose"][0]["uv"])
                body_img = io.imread(crop_img_path)
                bboxes, valids = part_boxes(labels, parts, dev)
                for (_, save_name), (x, y, w, h), valid in zip(parts, bboxes, valids):
                    if not valid:
                        continue  # no component, or < MIN_PART_SIZE (:122-123,148-149)
                    target = Path(cfg.CHALEARN.ROOT, save_name, nsetx3x5img)
                    if target.exists():
                        continue  # do-not-overwrite (:111-112)
                    _crop_write(io, body_img, x, y, w, h, target)
                    u8 = (uv[0][y:y + h, x:x + w] * 256.0).astype(np.uint8)
                    v8 = (uv[1][y:y + h, x:x + w] * 256.0).astype(np.uint8)
                    io.imwrite(target.parent / f"U_{target.name}", u8)
                    io.imwrite(target.parent / f"V_{target.name}", v8)
                    for i in range(interval):
                        fimg = io.imread(crop_img_path.parent / f"F{i}_{crop_img_path.name}")
                        _crop_write(io, fimg, x, y, w, h, target.parent / f"F{i}_{target.name}")
                    dimg = io.imread(crop_img_path.parent / f"D_{crop_img_path.name}")
                    _crop_write(io, dimg, x, y, w, h, target.parent / f"D_{target.name}")


# The stages in the chain's order, by the CLI's names; the reference's chain
# (run_data_preprocess.sh:8-15) runs FULL_CHAIN.
STAGES = ("sample", "images", "flow", "energy", "pad", "iuv", "cse", "crop")
FULL_CHAIN = ("sample", "images", "flow", "pad", "iuv", "crop")


def run_stages(cfg, names: Sequence[str], provider: Optional[IUVProvider] = None,
               sets: Sequence[str] = SETS, flow_params: FlowParams = DEFAULT_PARAMS,
               io=None, device=None, timer=None) -> None:
    """Run the named stages in the chain's order (``provider`` is needed by
    "iuv" and "cse"). ``timer`` (utils/profiling.StageTimer) times each
    stage by its name."""
    unknown = sorted(set(names) - set(STAGES))
    if unknown:
        raise ValueError(f"unknown stages {unknown}; choose from {STAGES}")
    io = _io(io)
    calls = {
        "sample": lambda: sample_data(cfg, sets),
        "images": lambda: video_to_images(cfg, io=io),
        "flow": lambda: video_to_flow(cfg, flow_params, io=io, device=device),
        "energy": lambda: filter_img_by_flow(cfg, io=io, device=device),
        "pad": lambda: image_to_padded(cfg, io=io),
        "iuv": lambda: padded_to_iuv(cfg, provider, sets=sets, io=io),
        "cse": lambda: padded_to_cse(cfg, provider, sets=sets, io=io),
        "crop": lambda: iuv_to_crop(cfg, sets=sets, io=io, device=device),
    }
    for name in STAGES:
        if name in names:
            with timer(name) if timer is not None else nullcontext():
                calls[name]()


def run_full_pipeline(cfg, provider: IUVProvider, flow_params: FlowParams = DEFAULT_PARAMS,
                      sets: Sequence[str] = SETS, io=None, device=None) -> None:
    """The whole offline chain (run_data_preprocess.sh:8-15)."""
    run_stages(cfg, FULL_CHAIN, provider, sets, flow_params, io=io, device=device)
