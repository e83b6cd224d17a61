"""Wall time per named stage, synchronised with the device."""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch


class StageTimer:
    """``with timer("flow"): ...`` adds the stage's wall time to
    ``timer.seconds["flow"]``. On a CUDA device it synchronises at both ends,
    so a stage's time includes the kernels it queued."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.seconds = defaultdict(float)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def __call__(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.seconds[name] += time.perf_counter() - t0
