"""The SOR tiles' schedule (``csrc/sor_tiles.cuh``), emulated on the CPU.

K4 (``csrc/sor_solve.cu``) and K1's SOR (``csrc/flow_level.cu``) run their
red-black half-sweeps in shared-memory tiles. The kernels run only on the
card; this file replays their schedule with plain tensor ops and the plain
twin's arithmetic, with the numbers of ``ops/sor_solve.py`` (``TILE``,
``HALF_SWEEPS``, ``whole_frame``), and holds the stitched result
``torch.equal`` to ``sor_solve_reference``:

- a frame of at most ``TILE`` is one tile with no halo, all half-sweeps in
  one launch; a larger one is cut into
  interiors of ``TILE - 2 HALF_SWEEPS``, each loaded with a halo of
  ``HALF_SWEEPS`` pixels clipped to the frame, ``HALF_SWEEPS`` half-sweeps
  per launch and a shorter last launch;
- half-sweep j (1-based) of a launch updates only the pixels at least j
  pixels inside every window edge that is not a frame edge; even half-sweeps
  of the solve are red;
- neighbours outside the frame are 0; neighbours outside the window but
  inside the frame are NaN here, so a pixel that read one would poison the
  result;
- each launch reads (du, dv) from one buffer and writes the interiors to
  the other (which starts as NaN, so a pixel no interior covers shows); the
  destinations alternate so that the last is the output, and the start is
  never the first destination, for K4's separate warm start and for K1's
  zero start inside the pair of buffers.

Inputs are made with numpy from seeds. The header's compiled numbers are
read from the source, and a header edit must change the extension's build
hash.
"""

import inspect
import re
import shutil

import numpy as np
import pytest
import torch
from torch.utils._cpp_extension_versioner import ExtensionVersioner

from video_classification_tpu_torch.ops.sor_solve import (
    HALF_SWEEPS, SCHEDULE, TILE, _neighbour, check_tileable, sor_solve,
    sor_solve_reference, whole_frame)
from video_classification_tpu_torch.utils import cuda
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)

# 64x64 is the largest whole frame; 65x64 and 64x65 the first shapes past it.
SHAPES = [(2, 2), (7, 9), (24, 32), (57, 76), (64, 64), (65, 64), (64, 65),
          (76, 101), (101, 135), (240, 320)]
SWEEPS = [1, HALF_SWEEPS // 2 - 1, HALF_SWEEPS // 2, HALF_SWEEPS // 2 + 1, 30]
ALPHA, OMEGA = 0.012, 1.8


def _system(h, w, seed, warm):
    """One pair's normal equations, edge weights zero across the border, a
    flow and a cold or warm start, as (B=1, h, w) float32 tensors."""
    rng = np.random.RandomState(seed)

    def f():
        return rng.rand(1, h, w).astype(np.float32)

    phi = 0.2 + 2.0 * f()
    p = np.pad(phi, ((0, 0), (1, 1), (1, 1)), mode="edge")
    wu, wd = 0.5 * (phi + p[:, :-2, 1:-1]), 0.5 * (phi + p[:, 2:, 1:-1])
    wl, wr = 0.5 * (phi + p[:, 1:-1, :-2]), 0.5 * (phi + p[:, 1:-1, 2:])
    wu[:, 0], wd[:, -1], wl[:, :, 0], wr[:, :, -1] = 0, 0, 0, 0
    arrays = [0.5 + f(), (f() - 0.5) * 0.6, 0.5 + f(),
              rng.randn(1, h, w).astype(np.float32),
              rng.randn(1, h, w).astype(np.float32), wu, wd, wl, wr,
              (f() - 0.5) * 6.0, (f() - 0.5) * 6.0]
    start = [(f() - 0.5) * 0.5 for _ in range(2)] if warm else \
        [np.zeros((1, h, w), np.float32)] * 2
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32))
            for a in arrays + start]


def _tiles(h, w):
    """(tiles, half-sweeps per launch or None for all): each tile is
    (interior, window), both (y0, y1, x0, x1)."""
    if whole_frame(h, w):
        return [((0, h, 0, w), (0, h, 0, w))], None
    ih, iw = TILE[0] - 2 * HALF_SWEEPS, TILE[1] - 2 * HALF_SWEEPS
    tiles = []
    for y0 in range(0, h, ih):
        for x0 in range(0, w, iw):
            y1, x1 = min(y0 + ih, h), min(x0 + iw, w)
            tiles.append(((y0, y1, x0, x1),
                          (max(y0 - HALF_SWEEPS, 0), min(y1 + HALF_SWEEPS, h),
                           max(x0 - HALF_SWEEPS, 0), min(x1 + HALF_SWEEPS, w))))
    return tiles, HALF_SWEEPS


def _window_neighbour(f, ws, window, h, w):
    """_neighbour over one window: 0 past a frame edge, NaN past a window
    edge inside the frame."""
    y0, y1, x0, x1 = window
    pad = torch.full((f.shape[0], y1 - y0 + 2, x1 - x0 + 2), float("nan"))
    if y0 == 0:
        pad[:, 0] = 0.0
    if y1 == h:
        pad[:, -1] = 0.0
    if x0 == 0:
        pad[:, :, 0] = 0.0
    if x1 == w:
        pad[:, :, -1] = 0.0
    pad[:, 1:-1, 1:-1] = f
    wu, wd, wl, wr = ws
    return (wu * pad[:, :-2, 1:-1] + wd * pad[:, 2:, 1:-1]
            + wl * pad[:, 1:-1, :-2] + wr * pad[:, 1:-1, 2:])


def _run_tile(fields, du, dv, window, first, n, h, w):
    """n half-sweeps from first on one window's fields; returns (du, dv)."""
    a12, b1, b2, wu, wd, wl, wr, inv_u, inv_v, nuc, nvc = fields
    ws = (wu, wd, wl, wr)
    y0, y1, x0, x1 = window
    rows = torch.arange(y0, y1).view(1, -1, 1)
    cols = torch.arange(x0, x1).view(1, 1, -1)
    colour = (rows + cols) % 2
    for j in range(n):
        d = j + 1
        region = ((rows >= y0 + d) | (y0 == 0)) & ((rows < y1 - d) | (y1 == h)) \
            & ((cols >= x0 + d) | (x0 == 0)) & ((cols < x1 - d) | (x1 == w))
        mask = (colour == (first + j) % 2) & region
        su = nuc + _window_neighbour(du, ws, window, h, w)
        new_du = (b1 - a12 * dv + ALPHA * su) * inv_u
        du = torch.where(mask, (1 - OMEGA) * du + OMEGA * new_du, du)
        sv = nvc + _window_neighbour(dv, ws, window, h, w)
        new_dv = (b2 - a12 * du + ALPHA * sv) * inv_v
        dv = torch.where(mask, (1 - OMEGA) * dv + OMEGA * new_dv, dv)
    return du, dv


def tiled_solve(a11, a12, a22, b1, b2, wu, wd, wl, wr, u, v, n_sor, du0, dv0,
                zero_start_in_buffers=False):
    """The kernels' schedule. With zero_start_in_buffers (K1), the start is
    written into the buffer that is not the first destination."""
    _, h, w = a11.shape
    wsum = wu + wd + wl + wr
    inv_u = 1.0 / (a11 + ALPHA * wsum)
    inv_v = 1.0 / (a22 + ALPHA * wsum)
    nuc = _neighbour(u, wu, wd, wl, wr) - wsum * u
    nvc = _neighbour(v, wu, wd, wl, wr) - wsum * v
    coeffs = (a12, b1, b2, wu, wd, wl, wr, inv_u, inv_v, nuc, nvc)

    tiles, per_launch = _tiles(h, w)
    n_half = 2 * n_sor
    per_launch = per_launch or max(n_half, 1)
    launches = -(-n_half // per_launch)
    buffers = {"out": None, "scratch": None, "start": (du0, dv0)}
    src = "start"
    if zero_start_in_buffers:
        src = "scratch" if launches % 2 else "out"
        buffers[src] = (du0, dv0)
    for i in range(launches):
        dst = "out" if (launches - 1 - i) % 2 == 0 else "scratch"
        assert dst != src, "a launch would write the buffer it reads"
        first = i * per_launch
        n = min(per_launch, n_half - first)
        out = [torch.full_like(a11, float("nan")) for _ in range(2)]
        for (iy0, iy1, ix0, ix1), window in tiles:
            y0, y1, x0, x1 = window
            fields = [f[:, y0:y1, x0:x1] for f in coeffs]
            du, dv = (f[:, y0:y1, x0:x1] for f in buffers[src])
            du, dv = _run_tile(fields, du, dv, window, first, n, h, w)
            for o, t in zip(out, (du, dv)):
                o[:, iy0:iy1, ix0:ix1] = t[:, iy0 - y0:iy1 - y0, ix0 - x0:ix1 - x0]
        assert not any(torch.isnan(o).any() for o in out), "an interior is missing"
        buffers[dst] = tuple(out)
        src = dst
    return buffers["out"] if launches else buffers[src]


@pytest.mark.parametrize("start", ["cold", "warm", "K1 zero start"])
@pytest.mark.parametrize("n_sor", SWEEPS)
@pytest.mark.parametrize("hw", SHAPES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_tiled_schedule_equals_the_plain_solve(hw, n_sor, start):
    h, w = hw
    t = _system(h, w, seed=h * 1000 + w + n_sor, warm=start == "warm")
    want = sor_solve_reference(*t[:11], n_sor, ALPHA, OMEGA, t[11], t[12])
    got = tiled_solve(*t[:11], n_sor, t[11], t[12],
                      zero_start_in_buffers=start == "K1 zero start")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_the_shapes_cover_both_modes():
    """64x64 runs whole; one more row or column is tiled; the interiors cut
    a 240x320 frame into 6 x 8 tiles, a 57x76 level into 2 x 2; the sweep
    counts fall short of, fill and pass one tiled launch."""
    assert _tiles(64, 64)[1] is None and _tiles(43, 57)[1] is None
    assert _tiles(65, 64)[1] == _tiles(64, 65)[1] == HALF_SWEEPS
    interior = TILE[0] - 2 * HALF_SWEEPS
    assert len(_tiles(240, 320)[0]) == -(-240 // interior) * -(-320 // interior)
    assert len(_tiles(57, 76)[0]) == 4
    assert 2 * SWEEPS[1] < HALF_SWEEPS == 2 * SWEEPS[2] < 2 * SWEEPS[3]


def test_schedule_matches_the_compiled_header():
    """ops/sor_solve.py's numbers are the header's constexprs; a window's
    13 fields fit one block's 232,448 bytes of shared memory (11 staged for
    the next tile, du and dv of the current one)."""
    text = (cuda.CSRC / "sor_tiles.cuh").read_text()
    compiled = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}
    assert SCHEDULE == (compiled["kTileH"], compiled["kTileW"], compiled["kHalfSweeps"])
    assert TILE[0] > 2 * HALF_SWEEPS and TILE[1] > 2 * HALF_SWEEPS
    assert HALF_SWEEPS % 2 == 0 and TILE[1] == 64
    assert 13 * 4 * TILE[0] * TILE[1] <= 232448


def test_editing_the_header_alone_rebuilds(tmp_path):
    """torch's extension versioner hashes the sources and the build flags;
    the header's digest in the flags makes a header edit a new version."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda.CSRC, csrc)
    versioner = ExtensionVersioner()
    params = inspect.signature(versioner.bump_version_if_changed).parameters
    optional = {"with_sycl": False, "is_python_module": True, "is_standalone": False}

    def version():
        return versioner.bump_version_if_changed(
            "vct_kernels", [str(csrc / s) for s in cuda.SOURCES],
            build_arguments=[["-O2"], cuda.cuda_flags(csrc), None, None],
            build_directory=str(tmp_path), with_cuda=True,
            **{k: v for k, v in optional.items() if k in params})

    first = version()
    assert version() == first
    header = csrc / "sor_tiles.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert version() == first + 1


def test_untileable_batches_raise():
    check_tileable(65536, 1, 1)
    for shape in [(1, 0, 4), (1, 4, 0), (0, 4, 4)]:
        with pytest.raises(ValueError, match="cannot cover"):
            check_tileable(*shape)
    z = torch.zeros((1, 4, 4))
    assert sor_solve(z + 1, *[z] * 10, 1, ALPHA, OMEGA)[0].shape == (1, 4, 4)


def test_profile_groups_name_every_kernel():
    """profile_serving puts every __global__ kernel of csrc/*.cu in its
    file's group, and raises on a port kernel that no group names."""
    from video_classification_tpu_torch.profile_serving import _group

    groups = {"flow_level.cu": "flow_level", "sor_solve.cu": "sor_solve",
              "component_extents.cu": "component_extents", "nms.cu": "nms",
              "warp.cu": "warp_bilinear", "label_components.cu": "label_components"}
    pattern = r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)\("
    for source, group in groups.items():
        names = re.findall(pattern, (cuda.CSRC / source).read_text())
        assert names, source
        for name in names:
            assert _group(f"(anonymous namespace)::{name}(int, float*)") == group
    assert set(groups) == {s for s in cuda.SOURCES if s.endswith(".cu")}
    with pytest.raises(RuntimeError, match="in no group"):
        _group("(anonymous namespace)::sor_kernel(Level, int, int)")
    assert _group("void at::native::vectorized_elementwise_kernel<4>(int)") == "other"
    # Template kernels: the port's by their names, PyTorch's own anonymous
    # namespaces' left to "other".
    assert _group("void (anonymous namespace)::extents_cluster_kernel<4>(int)") \
        == "component_extents"
    assert _group("void (anonymous namespace)::elementwise_kernel_with_index<int>(int)") \
        == "other"
