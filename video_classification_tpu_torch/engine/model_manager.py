"""Model construction and batch -> model-input mapping (SlowFast streams).

Port of the slowfast branch of the JAX package's ``engine/model_manager.py``.
A batch (N, T, H, W, 21) uint8, channels-last: 0:3 BGR, 3:5 UV, 5:20 flow
(5 frames x 3), 20:21 depth. The channels are split first (BGR+UV to the slow
pathway, flow to the fast one, depth unused; train.py:125-145), then
normalized to the compute dtype and moved to NCDHW. Serving applies no
augmentation.
"""

from __future__ import annotations

from typing import List

import torch

from ..config.crop_cfg import crop_resize_dict
from ..models.slowfast import SlowFast, init_my_slowfast, init_weights
from ..ops.image import normalize


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

    def normalize_and_prepare(self, x_uint8: torch.Tensor) -> List[torch.Tensor]:
        parts = [x_uint8[..., 0:5], x_uint8[..., 5:20]]
        return [normalize(p, self.compute_dtype).permute(0, 4, 1, 2, 3).contiguous()
                for p in parts]
