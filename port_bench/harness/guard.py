"""The run's guard against the JAX package: no module whose top-level name
(the part before the first dot) is one of ``FORBIDDEN`` may be loaded in
the process that prints the result. ``video_classification_tpu_torch`` is
a name of its own and passes."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "video_classification_tpu", "bench", "benchmarks")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    names = list(sys.modules) if names is None else list(names)
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})
