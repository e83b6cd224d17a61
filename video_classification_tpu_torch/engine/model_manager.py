"""Model construction and batch -> model-input mapping (SlowFast streams).

Port of the slowfast branch of the JAX package's ``engine/model_manager.py``.
A batch (N, T, H, W, 21) uint8, channels-last: 0:3 BGR, 3:5 UV, 5:20 flow
(5 frames x 3), 20:21 depth. The channels are split first (BGR+UV to the slow
pathway, flow to the fast one, depth unused; train.py:125-145), then
normalized to the compute dtype, cropped in training (RandomCrop, one window
per sample for both pathways), and moved to NCDHW.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..config.crop_cfg import crop_resize_dict
from ..models.slowfast import SlowFast, init_my_slowfast, init_weights
from ..ops.image import normalize, random_crop_batch, random_crop_offsets


class ModelManager:
    def __init__(self, cfg, device: torch.device):
        name = cfg.MODEL.NAME
        if "slowfast" not in name:
            raise NotImplementedError(
                f"MODEL.NAME {name!r}: only the slowfast streams are ported")
        self.cfg = cfg
        self.device = device
        self.crop_size = crop_resize_dict[cfg.MODEL.R3D_INPUT]
        self.compute_dtype = getattr(torch, str(cfg.CUDA.COMPUTE_DTYPE))
        self.param_dtype = getattr(torch, str(cfg.CUDA.PARAM_DTYPE))

    def init_model(self) -> SlowFast:
        """The stream's SlowFast with seeded random weights (CUDA.SEED), on
        the device, in eval mode."""
        model = init_my_slowfast(self.cfg, (5, 15), (64, 8))
        gen = torch.Generator().manual_seed(int(self.cfg.CUDA.SEED))
        init_weights(model, gen)
        return model.to(self.device, self.param_dtype).eval()

    @property
    def crop_padding(self) -> int:
        return self.crop_size // 10

    def crop_offsets(self, x_uint8: torch.Tensor,
                     generator: torch.Generator) -> torch.Tensor:
        """(N, 2) RandomCrop offsets for a (N, T, H, W, 21) batch, drawn from
        ``generator``."""
        n, _, h, w = x_uint8.shape[:4]
        return random_crop_offsets(n, h, w, self.crop_size, self.crop_padding, generator)

    def normalize_and_prepare(self, x_uint8: torch.Tensor,
                              offsets: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """(N, T, H, W, 21) uint8 -> [slow (N, 5, T, S, S), fast (N, 15, T, S,
        S)] in the compute dtype. With ``offsets`` (N, 2) each pathway is
        cropped after normalizing (zero fill in normalized space) at the same
        per-sample window."""
        parts = [x_uint8[..., 0:5], x_uint8[..., 5:20]]
        out = []
        for p in parts:
            x = normalize(p, self.compute_dtype)
            if offsets is not None:
                x = random_crop_batch(x, offsets, self.crop_size, self.crop_padding)
            out.append(x.permute(0, 4, 1, 2, 3).contiguous())
        return out
