"""Model construction and batch -> model-input mapping.

Port of the JAX package's ``engine/model_manager.py``: selects the network
by ``MODEL.NAME`` ('res2d' | 'res3d' | 'slowfast-*', train.py:39-145) and
owns the mapping of a batch (N, T, H, W, 21) uint8, channels-last (0:3 BGR,
3:5 UV, 5:20 flow, 5 frames x 3; 20:21 depth) to the network's input. The
channels are split first: SlowFast takes BGR+UV on the slow pathway and the
flow on the fast one (train.py:125-145), res3d and res2d take BGR+UV; depth
is unused. Each part is then normalized to the compute dtype, cropped in
training (RandomCrop, one window per sample, the same for both pathways),
and laid out for its network: NCDHW for the 3D models, and for res2d NCHW
with the T frames x 5 channels stacked T-major (channel t * 5 + c, the
reference's reshape of NTCHW, train.py:70-76).
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch
import torch.nn as nn

from ..config.crop_cfg import crop_resize_dict
from ..models.res3d import init_res3d
from ..models.resnet2d import init_res2d
from ..models.slowfast import init_my_slowfast, init_weights
from ..ops.image import normalize, random_crop_batch, random_crop_offsets


def _ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3).contiguous()


def _nchw_t_major(x: torch.Tensor) -> torch.Tensor:
    n, t, h, w, c = x.shape
    return x.permute(0, 1, 4, 2, 3).reshape(n, t * c, h, w).contiguous()


class ModelManager:
    def __init__(self, cfg, device: torch.device):
        name = cfg.MODEL.NAME
        if name == "res2d":
            self._init, self._channels, self._layout = init_res2d, [(0, 5)], _nchw_t_major
        elif name == "res3d":
            self._init, self._channels, self._layout = init_res3d, [(0, 5)], _ncdhw
        elif "slowfast" in name:
            self._init = lambda c: init_my_slowfast(c, (5, 15), (64, 8))
            self._channels, self._layout = [(0, 5), (5, 20)], _ncdhw
        else:
            raise NotImplementedError(name)
        self.cfg = cfg
        self.device = device
        self.crop_size = crop_resize_dict[cfg.MODEL.R3D_INPUT]
        self.compute_dtype = getattr(torch, str(cfg.CUDA.COMPUTE_DTYPE))
        self.param_dtype = getattr(torch, str(cfg.CUDA.PARAM_DTYPE))

    def init_model(self) -> nn.Module:
        """The stream's network with seeded random weights (CUDA.SEED), on
        the device, in eval mode."""
        model = self._init(self.cfg)
        gen = torch.Generator().manual_seed(int(self.cfg.CUDA.SEED))
        init_weights(model, gen)
        return model.to(self.device, self.param_dtype).eval()

    def _normalize(self, x_uint8: torch.Tensor) -> torch.Tensor:
        """A uint8 part of the batch, normalized in the compute dtype."""
        return normalize(x_uint8, self.compute_dtype)

    @property
    def crop_padding(self) -> int:
        return self.crop_size // 10

    def crop_offsets(self, x_uint8: torch.Tensor, generator: torch.Generator,
                     rows: Optional[int] = None) -> torch.Tensor:
        """(N, 2) RandomCrop offsets for a (N, T, H, W, 21) batch, drawn from
        ``generator``; for ``rows`` rows of that frame size if given (a
        data-parallel rank draws for the global batch)."""
        n, _, h, w = x_uint8.shape[:4]
        return random_crop_offsets(n if rows is None else rows, h, w, self.crop_size,
                                   self.crop_padding, generator)

    def normalize_and_prepare(self, x_uint8: torch.Tensor,
                              offsets: Optional[torch.Tensor] = None
                              ) -> Union[torch.Tensor, List[torch.Tensor]]:
        """(N, T, H, W, 21) uint8 -> the network's input in the compute
        dtype: SlowFast [slow (N, 5, T, S, S), fast (N, 15, T, S, S)], res3d
        (N, 5, T, S, S), res2d (N, T * 5, S, S). With ``offsets`` (N, 2)
        each part is cropped after normalizing (zero fill in normalized
        space) at the same per-sample window."""
        out = []
        for lo, hi in self._channels:
            x = self._normalize(x_uint8[..., lo:hi])
            if offsets is not None:
                x = random_crop_batch(x, offsets, self.crop_size, self.crop_padding)
            out.append(self._layout(x))
        return out if len(out) > 1 else out[0]
