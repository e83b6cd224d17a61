"""Float32 operations of the flow of one frame pair (the program's K1 count).

``chip_smoke.py``'s count of the fused level's kernel, frozen here: per
pixel and outer, the warp and phi 40 + 7c, the coefficients 35 + 34c, 34
per SOR sweep and 8 to finish, for c = 3 channels, at the configured outers
and sweeps on every level of the pyramid. The per-pair early exit is not
subtracted: the count is of the work the parameters ask for.
"""

from __future__ import annotations

from ..reference.flow import FlowParams, pyramid_shapes


def ops_per_pixel_outer(c: int, n_sor: int) -> int:
    return 83 + 41 * c + 34 * n_sor


def pair_ops(h: int, w: int, p: FlowParams, c: int = 3) -> float:
    pixels = sum(a * b for a, b in pyramid_shapes(h, w, p.ratio, p.min_width))
    return float(pixels * p.n_outer * ops_per_pixel_outer(c, p.n_sor))
