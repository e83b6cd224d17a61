"""v2 conversion stages: video-native storage of flow, IUV, UV maps and part boxes.

Port of the JAX package's ``v2/convert.py`` (the reference's converters,
new_feature_test.py:158-436). Every file goes through a ``VideoIO`` over the
frame I/O backend the caller passes (``pipeline/frame_io``: ``Cv2FrameIO``
writes the JAX package's MJPG files, ``ArrayFrameIO`` lossless stacks at
the same names); the device work runs on ``device``, the card unless the
caller passes ``device="cpu"``:

  * ``ConvertVideoToFlow``: 2-channel flow videos in ``2_Flow_New``, frame
    pairs in chunks of ``batch_size`` (64). The variational method is
    ``ops/flow.coarse2fine_flow`` (K1 on each pyramid level) on the frames
    in RGB order, as the JAX package feeds them; the RAFT method is
    ``models/raft.RAFT`` on frames reflect-padded to a multiple of 8. The
    encoding clips to +-30 px, then /60 + 0.5, x255 and truncates to uint8.
  * ``ConvertVideoToIUVPkl``: an ``IUVProvider`` (the port's
    ``DensePoseIUVProvider``, K3, or the synthetic one) on the frames,
    zero-padded to twice their size, BGR -> one pkl per video in
    ``4_IUV_New`` (skip-if-exists).
  * ``ConvertIuvPklToUvVideo``: the first box's UV chart (x255, truncated)
    pasted into the padded canvas at the box's corner (truncated), un-padded
    -> a 2-channel video in ``5_UV_Video`` (skipped when its ``0_`` file
    exists).
  * ``ConvertIuvPklToPartBox``: per frame, the largest component of each
    part 1..24 of the first box's chart, all 24 masks in one K2 call
    (``ops/components.largest_component_bbox``), mapped to un-padded frame
    coordinates -> ``[T][25][xyxy | None]`` pickled in ``6_Box``.

The padded geometry of a video (its frame size, through the backend) puts
the un-padding offset at half the frame's width and height.
"""

from __future__ import annotations

import pickle
from glob import glob
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.components import largest_component_bbox
from ..ops.flow import DEFAULT_PARAMS, FlowParams, coarse2fine_flow
from ..pipeline.iuv_contract import IUVProvider
from ..pipeline.stages import pad2x
from ..utils.chapath import ChaPath
from ..utils.cuda import resolve_device
from .video_io import VideoIO

NUM_PARTS = 25  # 0..24, 0 = background
FLOW_CLIP = 30.0  # px; the v2 encoding (new_feature_test.py:222-225)


def _sample_m_videos(cfg) -> List[Path]:
    root = Path(cfg.CHALEARN.ROOT, cfg.CHALEARN.SAMPLE)
    return [Path(p) for p in sorted(glob(str(root / "**" / "M_*.avi"), recursive=True))]


def encode_flow_v2(flow: torch.Tensor) -> torch.Tensor:
    """Flow in pixels -> uint8: clip +-30, /60 + 0.5, x255, truncated."""
    flow = torch.clamp(flow, -FLOW_CLIP, FLOW_CLIP) / 60 + 0.5
    return torch.clamp(flow * 255, 0, 255).to(torch.uint8)


class ConvertVideoToFlow:
    """Raw videos -> 2-channel flow videos (2_Flow_New).

    ``method="raft"`` needs weights: a torchvision raft_large ``.pth``
    (``raft_checkpoint``); RAFT runs in float32, as the JAX converter's."""

    def __init__(self, cfg, flow_params: FlowParams = DEFAULT_PARAMS,
                 batch_size: int = 64, method: str = "variational", raft_iters: int = 12,
                 raft_checkpoint=None, io=None, device=None) -> None:
        if method not in ("variational", "raft"):
            raise ValueError(f"method {method!r}")
        self.cfg = cfg
        self.flow_base = cfg.CHALEARN.FLOW_VIDEO
        self.params = flow_params
        self.batch_size = batch_size
        self.method = method
        self.vio = VideoIO(io)
        self.device = resolve_device(device)
        self.raft = None
        if method == "raft":
            from ..models.raft import RAFT
            from ..models.raft_convert import load_raft_checkpoint

            if raft_checkpoint is None:
                raise ValueError("method='raft' needs raft_checkpoint: "
                                 "random weights give meaningless flow")
            self.raft = load_raft_checkpoint(raft_checkpoint, RAFT(num_iters=raft_iters))
            self.raft.to(self.device).eval()

    @torch.inference_mode()
    def pairs_flow(self, im1: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) [0, 1] RGB pairs on the device -> (B, 2, H, W) float32
        flow in pixels."""
        if self.raft is not None:
            up, _ = self.raft(im1, im2)
            return up.permute(0, 3, 1, 2)
        u, v = coarse2fine_flow(im1, im2, self.params)
        return torch.stack([u, v], dim=1)

    @torch.inference_mode()
    def flow_from_frames(self, frames: np.ndarray) -> Optional[np.ndarray]:
        """(T, H, W, 3) BGR uint8 -> (T - 1, 2, H, W) encoded uint8 flow, or
        None for fewer than 2 frames."""
        if len(frames) < 2:
            return None
        rgb = torch.from_numpy(np.ascontiguousarray(frames[..., ::-1])).to(self.device)
        arr = rgb.float() / 255.0
        h, w = arr.shape[1:3]
        arr_in = arr
        if self.raft is not None:  # RAFT needs sides divisible by 8: reflect-pad, crop after
            arr_in = F.pad(arr.permute(0, 3, 1, 2), (0, (-w) % 8, 0, (-h) % 8),
                           mode="reflect").permute(0, 2, 3, 1)
        flows = []
        for start in range(0, len(arr) - 1, self.batch_size):
            end = min(len(arr) - 1, start + self.batch_size)
            f = self.pairs_flow(arr_in[start:end], arr_in[start + 1:end + 1])
            flows.append(f[:, :, :h, :w])
        return encode_flow_v2(torch.cat(flows, dim=0)).cpu().numpy()

    def convert(self) -> None:
        for avi in _sample_m_videos(self.cfg):
            frames = self.vio.io.read_video(avi)  # BGR
            flow_arr = self.flow_from_frames(np.stack(frames)) if frames else None
            if flow_arr is None:
                print(f"Skip corrupted file at {avi}")
                continue
            self.vio.write_video_TCHW(ChaPath(avi).change_base(self.flow_base).path, flow_arr)


class ConvertVideoToIUVPkl:
    """Raw videos -> per-video IUV pkl (4_IUV_New)."""

    def __init__(self, cfg, provider: IUVProvider, io=None) -> None:
        self.cfg = cfg
        self.iuv_base = cfg.CHALEARN.IUV_NEW
        self.provider = provider
        self.vio = VideoIO(io)

    def convert(self) -> None:
        for avi in _sample_m_videos(self.cfg):
            pkl_path = ChaPath(avi).change_base(self.iuv_base).path.with_suffix(".pkl")
            if pkl_path.exists():
                continue  # skip-if-exists (new_feature_test.py:248-249)
            frames = self.vio.io.read_video(avi)  # BGR, what the detector takes
            if not frames:
                continue
            padded = np.stack([pad2x(f) for f in frames])
            dets = self.provider.detect(padded, [str(avi)] * len(frames))
            results = [
                {
                    "file_name": str(avi),
                    "pred_boxes_XYXY": d.boxes_xyxy,
                    "scores": d.scores,
                    "pred_densepose": [{"labels": d.labels, "uv": d.uv}],
                }
                for d in dets
            ]
            pkl_path.parent.mkdir(parents=True, exist_ok=True)
            with pkl_path.open("wb") as f:
                pickle.dump(results, f)


class PadGeometry:
    """The padded-frame geometry of a video, from its frame size."""

    def __init__(self, vio: VideoIO, video: Path):
        self.img_h, self.img_w = vio.frame_size(video)
        self.y_pad = self.img_h // 2
        self.x_pad = self.img_w // 2
        self.pad_h = self.img_h * 2
        self.pad_w = self.img_w * 2


def _iuv_pkls(cfg) -> List[Path]:
    folder = Path(cfg.CHALEARN.ROOT, cfg.CHALEARN.IUV_NEW)
    return [Path(p) for p in sorted(glob(str(folder / "**" / "*.pkl"), recursive=True))]


def _sample_video(cfg, pkl_path: Path) -> Path:
    return ChaPath(pkl_path).change_base(cfg.CHALEARN.SAMPLE).path.with_suffix(".avi")


class ConvertIuvPklToUvVideo:
    """IUV pkls -> un-padded UV chart videos (5_UV_Video)."""

    def __init__(self, cfg, io=None) -> None:
        self.cfg = cfg
        self.uv_vid_base = cfg.CHALEARN.UV_VIDEO
        self.vio = VideoIO(io)

    def uv_maps(self, results, geo: PadGeometry) -> np.ndarray:
        """(T, 2, H, W) uint8 UV maps of one video's IUV results."""
        uv_maps = []
        for result in results:
            bg = np.zeros((2, geo.pad_h, geo.pad_w), np.uint8)
            box = result["pred_boxes_XYXY"]
            if len(box) == 0:
                print("No detection")
            else:
                x1, y1, _, _ = np.asarray(box[0]).astype(int)
                uv = (np.asarray(result["pred_densepose"][0]["uv"]) * 255.0).astype(np.uint8)
                map_h, map_w = uv.shape[1:]
                y2 = min(y1 + map_h, geo.pad_h)
                x2 = min(x1 + map_w, geo.pad_w)
                bg[:, y1:y2, x1:x2] = uv[:, : y2 - y1, : x2 - x1]
            uv_maps.append(
                bg[:, geo.y_pad:geo.y_pad + geo.img_h, geo.x_pad:geo.x_pad + geo.img_w])
        return np.stack(uv_maps)

    def convert(self) -> None:
        for pkl_path in _iuv_pkls(self.cfg):
            out = ChaPath(pkl_path).change_base(self.uv_vid_base).path.with_suffix(".avi")
            if (out.parent / f"0_{out.name}").exists():
                continue  # skip-if-exists (new_feature_test.py:317-318)
            with pkl_path.open("rb") as f:
                results = pickle.load(f)
            geo = PadGeometry(self.vio, _sample_video(self.cfg, pkl_path))
            self.vio.write_video_TCHW(out, self.uv_maps(results, geo))


class ConvertIuvPklToPartBox:
    """IUV pkls -> per-video [T][25][xyxy | None] part-box pkl (6_Box)."""

    def __init__(self, cfg, io=None, device=None) -> None:
        self.cfg = cfg
        self.box_base = cfg.CHALEARN.BOX
        self.vio = VideoIO(io)
        self.device = resolve_device(device)

    def part_boxes(self, results, geo: PadGeometry) -> List[List[Optional[tuple]]]:
        parts = torch.arange(1, NUM_PARTS, device=self.device)[:, None, None]
        box_list = []
        for result in results:
            box_part: List[Optional[tuple]] = [None] * NUM_PARTS
            human_box = result["pred_boxes_XYXY"]
            if len(human_box) != 0:
                hx1, hy1, _, _ = np.asarray(human_box[0]).astype(int)
                labels = torch.from_numpy(np.ascontiguousarray(
                    result["pred_densepose"][0]["labels"])).to(self.device)
                bboxes, valids = largest_component_bbox(labels[None] == parts)
                bboxes, valids = bboxes.cpu().numpy(), valids.cpu().numpy()
                for p, ((x, y, w, h), valid) in enumerate(zip(bboxes, valids), start=1):
                    if not valid:
                        continue  # not detected or < 15 px (new_feature_test.py:388-391)
                    x1 = int(x) + hx1 - geo.x_pad
                    y1 = int(y) + hy1 - geo.y_pad
                    box_part[p] = (x1, y1, x1 + int(w), y1 + int(h))
            box_list.append(box_part)
        return box_list

    def convert(self) -> None:
        for pkl_path in _iuv_pkls(self.cfg):
            box_path = ChaPath(pkl_path).change_base(self.box_base).path
            box_path.parent.mkdir(parents=True, exist_ok=True)
            with pkl_path.open("rb") as f:
                results = pickle.load(f)
            boxes = self.part_boxes(results, PadGeometry(self.vio, _sample_video(self.cfg,
                                                                                 pkl_path)))
            with box_path.open("wb") as f:
                pickle.dump(boxes, f)
