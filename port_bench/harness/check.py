"""The numbers a run's correctness check compares, each against its limit.

Serving: ``logp_gap`` is the widest gap, over the sampled requests' clips,
streams and classes and each video's mean of its clips, between the natural
logarithms of the program's and the reference's probabilities: a gap of g
means a probability off by a factor e^g. ``fused_gap`` (the ensemble) is the
same of the fused video probabilities against the reference's fusion of the
program's own stream scores (which ``logp_gap`` judges), so it judges the
fusion alone; ``fused_e2e_gap``, printed and not compared, holds them
against the reference's fusion of its own stream scores. ``flow_off`` is the
share of the moving pixels of the sampled requests' flow images (every
window, every stream) whose program and reference images differ by more
than ``FLOW_TOL`` uint8 levels in a channel; a pixel moves where either
image departs from the encoding of zero motion by more than ``FLOW_TOL``.
``clips_off`` counts the sampled requests whose clip count differs from the
reference's.

Training, over the leaves (parameter tensors) the reference's first
gradient moves, i.e. whose gradient norm is at least a thousandth of the
median leaf's (a leaf below that moves under Adam by round-off alone):

  * ``loss_gap``: the largest |program - reference| / |reference| of the
    three steps' losses (printed, not compared: bfloat16 and the fp8
    control read alike on it);
  * ``grad_gap``: the median over the leaves of |‖g_program‖ -
    ‖g_reference‖| / ‖g_reference‖, for the first step's gradient, the
    program's worked out from its optimizer's state after that step (the
    worst leaf's gap swings from seed to seed in bfloat16: a few BatchNorm
    leaves' gradients are sums that cancel almost exactly, which bfloat16's
    rounding of the terms upsets; see ``worst_leaves``);
  * ``update_gap``: the worst leaf's |‖d_program‖ - ‖d_reference‖| over the
    larger of ‖d_reference‖ of that leaf and of the median leaf, d each
    leaf's change over the three steps.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

TINY = 1e-30
FLOW_TOL = 2                   # uint8 levels of the flow images: 2 x 10/255 px
ZERO_MOTION = (127, 127, 0)    # the encoding of u = v = 0 (u, v, magnitude)


def log_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    p = torch.as_tensor(program, dtype=torch.float64).clamp_min(TINY).log()
    r = torch.as_tensor(reference, dtype=torch.float64).clamp_min(TINY).log()
    if p.shape != r.shape:
        return math.inf
    return float((p - r).abs().max()) if p.numel() else 0.0


def serve_numbers(pairs: Dict[str, List[Tuple[torch.Tensor, torch.Tensor]]]) -> Dict[str, float]:
    """``pairs``: for each number, the (program, reference) probability
    arrays of the sample it compares."""
    out = {k: max((log_gap(p, r) for p, r in v), default=math.inf) for k, v in pairs.items()}
    out["clips_off"] = float(sum(1 for v in pairs.values() for p, r in v
                                 if tuple(p.shape) != tuple(r.shape)))
    return out


def flow_counts(program: torch.Tensor, reference: torch.Tensor,
                tol: int = FLOW_TOL) -> Tuple[int, int]:
    """(off, moving) pixel counts of two (N, H, W, 3) uint8 flow images."""
    p, r = program.to(torch.int16), reference.to(torch.int16)
    zero = torch.tensor(ZERO_MOTION, dtype=torch.int16, device=p.device)
    moving = ((p - zero).abs() > tol).any(-1) | ((r - zero).abs() > tol).any(-1)
    off = moving & ((p - r).abs() > tol).any(-1)
    return int(off.sum()), int(moving.sum())


def flow_off(pairs: List[Tuple[torch.Tensor, torch.Tensor]]) -> float:
    """The share of moving pixels off by more than ``FLOW_TOL``, over the
    (program, reference) flow images of ``pairs``; inf where there is
    nothing to compare or the shapes differ."""
    off = moving = 0
    for p, r in pairs:
        if tuple(p.shape) != tuple(r.shape):
            return math.inf
        o, m = flow_counts(p, r.to(p.device))
        off, moving = off + o, moving + m
    if not pairs:
        return math.inf
    return off / moving if moving else 0.0


def _leaf_gaps(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
               leaves: List[str]) -> float:
    pn = {k: float(program[k].double().norm()) for k in leaves}
    rn = {k: float(reference[k].double().norm()) for k in leaves}
    med = sorted(rn.values())[len(rn) // 2]
    return max(abs(pn[k] - rn[k]) / max(rn[k], med, TINY) for k in leaves)


def moved_leaves(ref_grad: Dict[str, torch.Tensor]) -> List[str]:
    norms = {k: float(g.double().norm()) for k, g in ref_grad.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return sorted(k for k, n in norms.items() if n >= 1e-3 * med)


def worst_leaves(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
                 leaves: List[str], n: int = 3) -> List[Tuple[str, float, float]]:
    """The ``n`` leaves of largest gap: (name, program norm, reference norm,
    gap), the gap as ``grad_gap`` and ``update_gap`` measure it."""
    rows = [(k, float(program[k].double().norm()), float(reference[k].double().norm()))
            for k in leaves]
    med = sorted(r[2] for r in rows)[len(rows) // 2]
    rows = [(k, p, r, abs(p - r) / max(r, med, TINY)) for k, p, r in rows]
    return sorted(rows, key=lambda r: -r[3])[:n]


def train_numbers(prog_loss: Sequence[float], ref_loss: Sequence[float],
                  prog_grad: Dict[str, torch.Tensor], ref_grad: Dict[str, torch.Tensor],
                  prog_delta: Dict[str, torch.Tensor], ref_delta: Dict[str, torch.Tensor]
                  ) -> Dict[str, float]:
    leaves = moved_leaves(ref_grad)
    loss_gap = max(abs(p - r) / max(abs(r), TINY) for p, r in zip(prog_loss, ref_loss))
    if len(prog_loss) != len(ref_loss) or not all(map(math.isfinite, prog_loss)):
        loss_gap = math.inf
    gaps = sorted(abs(float(prog_grad[k].double().norm()) - float(ref_grad[k].double().norm()))
                  / max(float(ref_grad[k].double().norm()), TINY) for k in leaves)
    return {"loss_gap": loss_gap,
            "grad_gap": gaps[len(gaps) // 2],
            "update_gap": _leaf_gaps(prog_delta, ref_delta, leaves)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """(correct, {name: {'value', 'limit'}}): correct when every number is
    finite and within its limit."""
    shown = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
    return ok, shown
