"""Precision of the reference: float32 with TF32 off, and the control's fp8.

``strict_float32`` turns TF32 off for matrix products and cuDNN
convolutions while the reference runs (on this GPU a float32 product may
otherwise run in TF32). ``FP8`` is the control of the correctness check:
the step below the bfloat16 compute the configurations state, the
reference's convolutions and head with their operands, and BatchNorm with
its outputs, rounded to fp8 E4M3, and the gradients of all their outputs to
fp8 E5M2, each tensor scaled by its own absolute maximum onto the format's
largest value (per-tensor scaling, as fp8 training and inference use it).
``BF16`` rounds the same tensors to bfloat16: the configurations' own
precision, emulated in the reference.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from .slowfast import Quant


@contextmanager
def strict_float32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _scaled_cast(dtype):
    top = float(torch.finfo(dtype).max)

    def cast(x: torch.Tensor) -> torch.Tensor:
        amax = x.detach().abs().amax()
        scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
        return ((x / scale).to(dtype).to(x.dtype)) * scale

    return cast


e4m3 = _scaled_cast(torch.float8_e4m3fn)
e5m2 = _scaled_cast(torch.float8_e5m2)
FP8 = Quant(cast=e4m3, grad_cast=e5m2)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


BF16 = Quant(cast=_bf16, grad_cast=_bf16)
