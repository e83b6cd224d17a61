"""K1's resident SOR schedule (``csrc/sor_resident.cuh``), emulated on the CPU.

K1's SOR (``csrc/flow_level.cu``) holds each frame on the chip for a whole
outer: one thread-block cluster a frame, a strip of rows a CTA. The kernel
runs only on the card; this file replays its schedule with plain tensor ops
and the plain twin's arithmetic (``hoisted``, ``weighted_sum``, ``relax``),
with the plan of ``ops/flow_level.py`` (``resident_plan``), and holds the
stitched result ``torch.equal`` to ``sor_solve_reference`` from a cold start:

- CTA r owns rows [r * rows, (r + 1) * rows) of the frame (the last CTA
  fewer), with one halo row above and one below: its state is rows + 2 rows,
  nothing else of the frame;
- it holds 9 of the 11 read-only fields, for its strip only, and wu's row
  below the strip (0 past the frame); the weight down is the weight up of
  the row below and the weight right the weight left of the next column;
- half-sweep j updates the strip's cells of colour j % 2 (red first);
  neighbours outside the frame are 0, and the halo rows past the frame are
  NaN here, so a pixel that read one would poison the result;
- before half-sweep j the halo cells of colour j % 2 are NaN (the
  neighbours rewrite them in that half-sweep, so no cell of this one may
  read them), and after it, but the last, the strips' first and last rows'
  cells of that colour go into the halo rows of the CTAs above and below:
  one exchange row per half-sweep (s = 1).

The plan's constants are read from the header's source, the serving levels'
schedules are counted, and the wrapper's counter and plan are checked on
meta tensors (no kernel runs).
"""

import re

import numpy as np
import pytest
import torch

from video_classification_tpu_torch.ops import flow_level as fl
from video_classification_tpu_torch.ops.flow import FlowParams, _pyramid_shapes
from video_classification_tpu_torch.ops.flow_level import (
    RESIDENT_CELLS, RESIDENT_COEFFS, RESIDENT_MAX_CLUSTER, RESIDENT_MAX_SMEM,
    RESIDENT_STATIC_SMEM, RESIDENT_THREADS, resident_plan, resident_smem_bytes,
    sor_schedule)
from video_classification_tpu_torch.ops.sor_solve import (
    hoisted, relax, sor_solve_reference, weighted_sum)
from video_classification_tpu_torch.utils import cuda, profiling
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)

SERVING_LEVELS = _pyramid_shapes(240, 320, FlowParams().ratio, FlowParams().min_width)
# 65x64 and 64x65: the first shapes past one SOR tile, one CTA each.
SHAPES = SERVING_LEVELS + [(65, 64), (64, 65)]
# Past every cluster: a 480x640 frame needs strips of 7 rows, 69 CTAs.
TOO_LARGE = (480, 640)
ALPHA, OMEGA = 0.012, 1.8
NAN = float("nan")


def _system(h, w, seed):
    """One pair's normal equations as K1's coefficient kernel leaves them:
    the half-point weights 0.5 * (phi + phi') of a phi, zero across the
    border, and a flow; (B=1, h, w) float32 tensors."""
    rng = np.random.RandomState(seed)

    def f():
        return torch.from_numpy(rng.rand(1, h, w).astype(np.float32))

    phi = 0.2 + 2.0 * f()
    wu, wd, wl, wr = (torch.zeros_like(phi) for _ in range(4))
    wu[:, 1:] = 0.5 * (phi[:, 1:] + phi[:, :-1])
    wd[:, :-1] = 0.5 * (phi[:, :-1] + phi[:, 1:])
    wl[:, :, 1:] = 0.5 * (phi[:, :, 1:] + phi[:, :, :-1])
    wr[:, :, :-1] = 0.5 * (phi[:, :, :-1] + phi[:, :, 1:])
    return [0.5 + f(), (f() - 0.5) * 0.6, 0.5 + f(),
            torch.from_numpy(rng.randn(1, h, w).astype(np.float32)),
            torch.from_numpy(rng.randn(1, h, w).astype(np.float32)), wu, wd, wl, wr,
            (f() - 0.5) * 6.0, (f() - 0.5) * 6.0]


def _strips(field, cluster, rows, extra=0, past=NAN):
    """(cluster, rows + extra, W): CTA r's rows [r * rows, (r + 1) * rows +
    extra) of a (1, H, W) field, ``past`` past the frame."""
    h, w = field.shape[1:]
    out = torch.full((cluster, rows + extra, w), past)
    for r in range(cluster):
        y0 = r * rows
        n = min(rows + extra, h - y0)
        out[r, :n] = field[0, y0:y0 + n]
    return out


def _shift_left(f):
    """out[..., x] = f[..., x + 1], 0 past the last column."""
    return torch.cat([f[..., 1:], torch.zeros_like(f[..., :1])], -1)


def _shift_right(f):
    """out[..., x] = f[..., x - 1], 0 before the first column."""
    return torch.cat([torch.zeros_like(f[..., :1]), f[..., :-1]], -1)


def resident_solve(a11, a12, a22, b1, b2, wu, wd, wl, wr, u, v, n_sor):
    """The resident schedule from a cold start: (du, dv), each (1, H, W).
    wd and wr are not read: the CTAs derive them from wu and wl."""
    _, h, w = a11.shape
    cluster, rows = resident_plan(h, w)
    assert cluster >= 1, f"{h}x{w} has no resident plan"
    inv_u, inv_v, nuc, nvc = hoisted(a11, a22, wu, wd, wl, wr, u, v, ALPHA)
    c_a12, c_b1, c_b2, c_wl, c_iu, c_iv, c_nuc, c_nvc = (
        _strips(f, cluster, rows) for f in (a12, b1, b2, wl, inv_u, inv_v, nuc, nvc))
    c_wu = _strips(wu, cluster, rows, extra=1, past=0.0)
    w_u, w_d, w_l, w_r = c_wu[:, :-1], c_wu[:, 1:], c_wl, _shift_left(c_wl)

    # Global row of each local row (row 0 the halo above), and colours.
    y = (torch.arange(cluster).view(-1, 1) * rows
         + torch.arange(-1, rows + 1).view(1, -1)).unsqueeze(-1)
    x = torch.arange(w).view(1, 1, -1)
    inside = (y >= 0) & (y < h)
    colour = (y + x) % 2
    state = [torch.where(inside, 0.0, NAN).expand(cluster, rows + 2, w).clone()
             for _ in range(2)]
    ys = y[:, 1:-1]
    halo = torch.zeros_like(inside.expand(cluster, rows + 2, w))
    halo[:, 0] = halo[:, -1] = True

    n = 2 * n_sor
    for j in range(n):
        c = j % 2
        for s in state:  # the halo cells this half-sweep's neighbours rewrite
            s[halo & (colour == c)] = NAN
        du, dv = state
        mask = ((ys + x) % 2 == c) & (ys < h)

        def around(s):
            return (torch.where(ys > 0, s[:, :-2], 0.0),
                    torch.where(ys < h - 1, s[:, 2:], 0.0),
                    _shift_right(s[:, 1:-1]), _shift_left(s[:, 1:-1]))

        du_c, dv_c = du[:, 1:-1], dv[:, 1:-1]
        su = c_nuc + weighted_sum(w_u, w_d, w_l, w_r, *around(du))
        du_n = relax(du_c, dv_c, c_b1, c_a12, su, c_iu, ALPHA, OMEGA)
        sv = c_nvc + weighted_sum(w_u, w_d, w_l, w_r, *around(dv))
        dv_n = relax(dv_c, du_n, c_b2, c_a12, sv, c_iv, ALPHA, OMEGA)
        du[:, 1:-1] = torch.where(mask, du_n, du_c)
        dv[:, 1:-1] = torch.where(mask, dv_n, dv_c)
        if j + 1 < n:
            for s in state:
                for r in range(1, cluster):
                    up, down = s[r - 1, -1], s[r, 0]
                    up[colour[r - 1, -1] == c] = s[r, 1][colour[r, 1] == c]
                    down[colour[r, 0] == c] = s[r - 1, -2][colour[r - 1, -2] == c]
    out = []
    for s in state:
        frame = s[:, 1:-1].reshape(cluster * rows, w)[:h]
        assert not torch.isnan(frame).any(), "a strip read a stale or outside cell"
        out.append(frame.unsqueeze(0))
    return out


@pytest.mark.parametrize("n_sor", [1, 30])
@pytest.mark.parametrize("hw", SHAPES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_resident_schedule_equals_the_plain_solve(hw, n_sor):
    h, w = hw
    t = _system(h, w, seed=h * 1000 + w + n_sor)
    want = sor_solve_reference(*t, n_sor, ALPHA, OMEGA)
    got = resident_solve(*t, n_sor)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _fits(rows, w):
    return (resident_smem_bytes(rows, w) + RESIDENT_STATIC_SMEM <= RESIDENT_MAX_SMEM
            and rows * ((w + 1) // 2) <= RESIDENT_CELLS * RESIDENT_THREADS)


def test_plan_matches_the_compiled_header():
    """ops/flow_level.py's constants are the header's constexprs; each plan
    is the fewest CTAs whose strips fit one block, or 16 CTAs' strips where
    the fewest are more than 8."""
    text = (cuda.CSRC / "sor_resident.cuh").read_text()
    compiled = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}
    assert (compiled["kMaxCluster"], compiled["kMaxSmem"], compiled["kStaticSmem"],
            compiled["kCoeffs"], compiled["kThreads"], compiled["kCells"]) == (
        RESIDENT_MAX_CLUSTER, RESIDENT_MAX_SMEM, RESIDENT_STATIC_SMEM,
        RESIDENT_COEFFS, RESIDENT_THREADS, RESIDENT_CELLS)
    assert "2 * pitch(W) * (kCoeffs * rows + 1 + 2 * (rows + 2))" in text
    assert "rows * pitch(W) <= kCells * kThreads" in text
    assert "if (c > kMaxCluster / 2) rows = (H + kMaxCluster - 1) / kMaxCluster;" in text
    assert "sor_resident.cuh" in cuda.HEADERS
    for h, w in SHAPES:
        cluster, rows = resident_plan(h, w)
        assert 1 <= cluster <= RESIDENT_MAX_CLUSTER and (cluster - 1) * rows < h <= cluster * rows
        assert _fits(rows, w)
        fewest = next(c for c in range(1, RESIDENT_MAX_CLUSTER + 1) if _fits(-(-h // c), w))
        if fewest > RESIDENT_MAX_CLUSTER // 2:
            assert rows == -(-h // RESIDENT_MAX_CLUSTER)
        else:
            assert cluster == fewest
    assert resident_plan(240, 320) == (16, 15) and resident_plan(180, 240) == (15, 12)
    assert resident_plan(57, 76) == (1, 57)


def test_every_serving_level_is_resident():
    """The nine levels of a 240x320 frame: three whole frames, six resident
    (16, 15, 5, 3, 2 and 1 CTAs); a frame past every cluster is tiled."""
    schedules = [sor_schedule(h, w) for h, w in SERVING_LEVELS]
    assert schedules == ["resident"] * 6 + ["whole"] * 3
    assert [resident_plan(h, w)[0] for h, w in SERVING_LEVELS[:6]] == [16, 15, 5, 3, 2, 1]
    assert sor_schedule(65, 64) == sor_schedule(64, 65) == "resident"
    assert resident_plan(*TOO_LARGE) == (0, 0) and sor_schedule(*TOO_LARGE) == "tiled"
    with pytest.raises(AssertionError, match="no resident plan"):
        resident_solve(*_system(*TOO_LARGE, seed=0), 1)


class _FakeExt:
    def __init__(self):
        self.plans = []

    def flow_level(self, im1, im2, u, v, *args):
        self.plans.append((tuple(u.shape[1:]), args[-1]))
        return u, v, u.new_empty(u.shape[:1])


@pytest.mark.parametrize("hw, counted", [((240, 320), "flow.sor_resident_levels"),
                                         ((43, 57), "flow.sor_resident_levels"),
                                         (TOO_LARGE, "flow.sor_tiled_levels")])
def test_the_wrapper_counts_the_schedule_and_passes_the_plan(monkeypatch, hw, counted):
    """On a non-CPU tensor the wrapper counts the level's schedule while a
    profiler records, and hands the binding the level's plan (meta tensors:
    the binding is a stand-in)."""
    ext = _FakeExt()
    monkeypatch.setattr(cuda, "build", lambda: ext)
    monkeypatch.setattr(profiling, "COUNTS", profiling.COUNTS.copy())
    h, w = hw
    im = torch.empty((2, h, w, 3), device="meta")
    uv = torch.empty((2, h, w), device="meta")
    p = FlowParams()
    call = (im, im, uv, uv, p.n_outer, p.n_sor, p.alpha, p.omega, p.eps,
            p.warp_radius, p.fuse_outer_tol)
    fl.flow_level(*call)
    assert not profiling.COUNTS[counted]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        fl.flow_level(*call)
    assert profiling.COUNTS[counted] == 1
    assert sum(profiling.COUNTS[k] for k in ("flow.sor_resident_levels",
                                             "flow.sor_tiled_levels")) == 1
    assert ext.plans == [((h, w), list(resident_plan(h, w)))] * 2
