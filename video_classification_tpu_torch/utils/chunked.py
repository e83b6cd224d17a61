"""Chunked execution of a batched graph over many items.

Port of the JAX package's ``utils/chunked.py``, shared by the detector
inference of ``detect/provider.py``: run N items through ``apply`` in chunks
of ``batch_size`` and concatenate the per-chunk dicts of tensors. The JAX
version pads the last chunk up to ``batch_size`` (repeating its last item)
so that one compiled program serves every chunk; PyTorch runs eagerly and
compiles nothing, so here the last chunk is simply shorter and nothing is
padded or dropped.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


def run_chunked(apply: Callable[[torch.Tensor], Dict[str, torch.Tensor]],
                items: torch.Tensor, batch_size: int,
                to_host: bool = False) -> Dict[str, torch.Tensor]:
    """``apply`` over ``items`` (N, ...) in chunks of ``batch_size`` along
    axis 0; returns ``apply``'s dict with each tensor concatenated along axis
    0, in item order.

    By default the outputs stay on their device. ``to_host=True`` moves each
    chunk's outputs to the CPU as soon as the chunk completes, so the device
    holds one chunk's outputs at a time rather than all N items' (long
    videos with large per-frame outputs, the charts and U/V fields)."""
    bs = max(1, int(batch_size))
    outs = []
    for lo in range(0, items.shape[0], bs):
        out = apply(items[lo:lo + bs])
        if to_host:
            out = {k: v.cpu() for k, v in out.items()}
        outs.append(out)
    if len(outs) == 1:
        return outs[0]
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
