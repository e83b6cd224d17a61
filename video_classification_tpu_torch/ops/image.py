"""Batched image ops of the device preprocessing (channels-last tensors).

Port of the JAX package's ``ops/image.py``:

  * ``cubic_resize``          - separable bicubic resize, OpenCV INTER_CUBIC
                                kernel (Keys, A=-0.75), replicate-clamped
                                borders, per-sample source sizes;
  * ``pad_to_square_resize``  - the reference ``_pad_resize_img``: centre the
                                content in a max(h, w) square, cubic-resize
                                to a fixed square (chalearn_dataset.py:60-71);
  * ``shift2d``               - per-sample 2-D shift/crop with zero fill;
  * ``normalize``             - (x/255 - 0.45)/0.225 (chalearn_dataset.py:41-46);
  * ``random_crop_batch``     - torchvision-style RandomCrop of a clip batch
                                with explicit offsets (``random_crop_offsets``
                                draws them from a torch.Generator);
  * ``resize_linear_u8``,     - the three ``cv2.resize`` calls of the
    ``resize_nearest``,         DensePose provider (detect/provider.py), each
    ``resize_linear_f32``       with OpenCV's own arithmetic, on batches.

The JAX package writes the shift and the crop as one-hot matmuls (a TPU
layout choice); here they are exact gathers. The cubic resampling keeps the JAX form, a
per-sample (out, canvas) weight matrix applied by a matrix product.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

_CUBIC_A = -0.75  # OpenCV's bicubic coefficient (interpolateCubic)

NORM_MEAN = 0.45
NORM_STD = 0.225


def _cubic_kernel(x: torch.Tensor, a: float = _CUBIC_A) -> torch.Tensor:
    """Keys cubic convolution kernel on |x| <= 2."""
    ax = torch.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    inner = (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0
    outer = a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a
    return torch.where(ax <= 1.0, inner,
                       torch.where(ax < 2.0, outer, torch.zeros_like(ax)))


def _resample_axis(img: torch.Tensor, dim: int, out_size: int,
                   in_size: torch.Tensor) -> torch.Tensor:
    """Cubic-resample dim ``dim`` (1 or 2) of (S, H, W, C) float32.

    ``in_size`` (S,) is each sample's true extent along ``dim``; samples past
    it are never touched because tap coordinates clamp to [0, in_size-1].
    OpenCV mapping: src = (dst + 0.5) * scale - 0.5."""
    canvas = img.shape[dim]
    dev = img.device
    in_f = in_size.to(torch.float32)[:, None]                  # (S, 1)
    scale = in_f / out_size
    dst = torch.arange(out_size, dtype=torch.float32, device=dev)[None, :]
    src = (dst + 0.5) * scale - 0.5                            # (S, out)
    base = torch.floor(src)
    frac = src - base
    tap_offsets = torch.arange(-1, 3, dtype=torch.float32, device=dev)
    tap_coords = base[..., None] + tap_offsets                  # (S, out, 4)
    hi = (in_f - 1.0)[..., None]
    tap_idx = torch.minimum(torch.clamp(tap_coords, min=0.0), hi).to(torch.int64)
    weights = _cubic_kernel(frac[..., None] - tap_offsets)      # (S, out, 4)
    tap_idx = torch.clamp(tap_idx, 0, canvas - 1)
    cols = torch.arange(canvas, device=dev)
    w = torch.sum(torch.where(cols == tap_idx[..., None], weights[..., None],
                              torch.zeros((), device=dev)), dim=2)  # (S, out, canvas)
    if dim == 1:
        return torch.einsum("soh,shwc->sowc", w, img)
    return torch.einsum("sow,shwc->shoc", w, img)


def cubic_resize(img: torch.Tensor, out_hw: Sequence[int], in_hw) -> torch.Tensor:
    """Bicubic resize of (S, H, W, C) to (S, out_h, out_w, C), float32.

    ``in_hw``: per-sample (h (S,), w (S,)) true extents of the content, which
    sits in the top-left corner of the canvas."""
    out = _resample_axis(img.float(), 1, int(out_hw[0]), in_hw[0])
    return _resample_axis(out, 2, int(out_hw[1]), in_hw[1])


def shift2d(img: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
            out_hw: Sequence[int]) -> torch.Tensor:
    """out[s, y, x] = img[s, y + dy[s], x + dx[s]], zero outside the image.

    img (S, H, W, ...) (any trailing dims, any strides); dy, dx (S,) integer
    tensors. Exact for every dtype."""
    s, h, w = img.shape[:3]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    dev = img.device
    ys = torch.arange(oh, device=dev)[None, :] + dy.to(torch.int64)[:, None]
    xs = torch.arange(ow, device=dev)[None, :] + dx.to(torch.int64)[:, None]
    inside = (((ys >= 0) & (ys < h))[:, :, None]
              & ((xs >= 0) & (xs < w))[:, None, :])             # (S, oh, ow)
    out = img[torch.arange(s, device=dev)[:, None, None],
              ys.clamp(0, h - 1)[:, :, None], xs.clamp(0, w - 1)[:, None, :]]
    inside = inside.view(inside.shape + (1,) * (img.dim() - 3))
    return torch.where(inside, out, torch.zeros((), dtype=img.dtype, device=dev))


def pad_to_square_resize(img: torch.Tensor, size: int, hw) -> torch.Tensor:
    """Centre each sample's content in a max(h, w) square, resize to ``size``.

    img (S, H, W, C) whose valid content is the top-left ``hw`` = (h (S,),
    w (S,)) region. Zero fill, nx = (m - w)//2, ny = (m - h)//2 centring,
    bicubic resize. Returns (S, size, size, C) float32."""
    s, hh, ww, c = img.shape
    dev = img.device
    h, w = hw
    m = torch.maximum(h, w)
    cm = max(hh, ww)
    nx = torch.div(m - w, 2, rounding_mode="floor")
    ny = torch.div(m - h, 2, rounding_mode="floor")
    canvas = torch.zeros((s, cm, cm, c), dtype=img.dtype, device=dev)
    canvas[:, :min(hh, cm), :min(ww, cm)] = img[:, :min(hh, cm), :min(ww, cm)]
    rows = torch.arange(cm, device=dev)
    valid = ((rows[None, :, None] < h[:, None, None])
             & (rows[None, None, :] < w[:, None, None]))
    canvas = torch.where(valid[..., None], canvas, torch.zeros((), dtype=img.dtype,
                                                               device=dev))
    square = shift2d(canvas, -ny, -nx, (cm, cm))
    return cubic_resize(square, (size, size), in_hw=(m, m))


def normalize(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 -> ((x/255) - 0.45) / 0.225 in ``dtype``."""
    x = x.to(torch.float32)
    out = (x * (1.0 / 255.0) - NORM_MEAN) * (1.0 / NORM_STD)
    return out.to(dtype)


def random_crop_offsets(n: int, h: int, w: int, size: int, padding: int,
                        generator: torch.Generator) -> torch.Tensor:
    """(n, 2) int64 window offsets (oy, ox) in the zero-padded frame, each
    uniform over [0, h + 2 * padding - size] and [0, w + 2 * padding - size],
    drawn from ``generator`` on its device."""
    dev = generator.device
    oy = torch.randint(0, h + 2 * padding - size + 1, (n,), generator=generator, device=dev)
    ox = torch.randint(0, w + 2 * padding - size + 1, (n,), generator=generator, device=dev)
    return torch.stack([oy, ox], dim=1)


def random_crop_batch(clips: torch.Tensor, offsets: torch.Tensor, size: int,
                      padding: int) -> torch.Tensor:
    """RandomCrop of (N, T, H, W, C) clips: zero-pad ``padding`` on every
    spatial side, then take the (size, size) window at ``offsets[n]`` =
    (oy, ox), one window per sample shared by every frame and channel (the
    JAX package's ``ops/image.random_crop_batch``, chalearn_dataset.py:73-87).
    The zero fill lives in whatever space ``clips`` is in: call it on the
    normalized tensor, as the reference does. Returns an (N, T, size, size,
    C) view of the gathered window."""
    off = offsets.to(device=clips.device, dtype=torch.int64)
    out = shift2d(clips.permute(0, 2, 3, 1, 4), off[:, 0] - padding,
                  off[:, 1] - padding, (size, size))      # (N, size, size, T, C)
    return out.permute(0, 3, 1, 2, 4)


def random_crop(clip: torch.Tensor, offset: torch.Tensor, size: int,
                padding: int) -> torch.Tensor:
    """``random_crop_batch`` of one (T, H, W, C) clip at ``offset`` (oy, ox)."""
    return random_crop_batch(clip[None], offset.reshape(1, 2), size, padding)[0]


# -- OpenCV's resize rules ------------------------------------------------------------
#
# The provider's three cv2.resize calls (the JAX package's detect/provider.py:110,
# 162-164), as found by testing against cv2 (tests/test_torch_port_resize_cv2.py):
#
#   INTER_NEAREST   src = min(floor(dst * (1 / (dst_n / src_n))), src_n - 1), float64.
#   INTER_LINEAR    src position p = (dst + 0.5) * scale - 0.5 per axis; the column
#                   taps clamp at the border (p < 0 or p >= src_n - 1 reads one
#                   column with weight 1), the row taps only clip their index.
#     uint8         float32 p, fraction f = p - floor(p) in float32, weights
#                   round(2048 (1 - f)) and round(2048 f); columns summed in int32,
#                   rows as ((b0 (r0 >> 4)) >> 16) + ((b1 (r1 >> 4)) >> 16), then
#                   (+ 2) >> 2 (OpenCV's fixed-point vertical pass).
#     float32       scale = src_n / dst_n in float64, f = float32(p - floor(p)); each
#                   pass a + (b - a) * f with one rounding (a fused multiply-add);
#                   a source with a side of 1 takes OpenCV's generic path instead:
#                   float32 p, a * (1 - f) + b * f rounded at every step.
#
# The taps are a few hundred numbers per axis, made on the host; the gathers and the
# arithmetic run on the tensor's device, in integer or separately rounded float ops,
# so the card and the CPU give the same bits.


def _positions(src_n: int, dst_n: int, scale: float, float32: bool
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(floor index int64, fraction float32) of p = (dst + 0.5) * scale - 0.5."""
    p = (np.arange(dst_n) + 0.5) * scale - 0.5
    if float32:
        p = p.astype(np.float32)
        s = np.floor(p).astype(np.int64)
        return s, (p - s.astype(np.float32)).astype(np.float32)
    s = np.floor(p).astype(np.int64)
    return s, (p - s).astype(np.float32)


def _linear_taps(src_n: int, dst_n: int, scale: float, float32: bool, clamp: bool):
    """(i0, i1, f): the two source indices and the float32 weight of i1."""
    s, f = _positions(src_n, dst_n, scale, float32)
    if clamp:
        edge = (s < 0) | (s >= src_n - 1)
        f = np.where(edge, np.float32(0.0), f)
        s = np.where(s < 0, 0, np.where(s >= src_n - 1, src_n - 1, s))
    return np.clip(s, 0, src_n - 1), np.clip(s + 1, 0, src_n - 1), f


def _fixed_point(f: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV's 11-bit weights: round-half-even of 2048 (1 - f) and 2048 f."""
    w0 = np.rint((np.float32(1.0) - f) * np.float32(2048.0)).astype(np.int32)
    return w0, np.rint(f * np.float32(2048.0)).astype(np.int32)


def _check_resize(x: torch.Tensor, out_hw, dtype) -> Tuple[int, int]:
    if x.dim() < 3:
        raise ValueError(f"expected (B, H, W, ...) images, got {tuple(x.shape)}")
    if dtype is not None and x.dtype != dtype:
        raise ValueError(f"expected {dtype}, got {x.dtype}")
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if min(oh, ow, x.shape[1], x.shape[2]) < 1:
        raise ValueError(f"empty resize {tuple(x.shape[1:3])} -> {(oh, ow)}")
    return oh, ow


def _index(n: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(n, np.int64)).to(dev)


def _along(t: np.ndarray, x: torch.Tensor, dim: int) -> torch.Tensor:
    """A per-index weight vector shaped to broadcast along ``dim`` of ``x``."""
    shape = [1] * x.dim()
    shape[dim] = t.shape[0]
    return torch.from_numpy(np.ascontiguousarray(t)).to(x.device).reshape(shape)


def resize_nearest(x: torch.Tensor, out_hw: Sequence[int]) -> torch.Tensor:
    """cv2.resize(..., INTER_NEAREST) of (B, H, W, ...) images of any dtype:
    a gather, so the values are the source's bits."""
    oh, ow = _check_resize(x, out_hw, None)
    h, w = x.shape[1:3]

    def rows(src_n, dst_n):
        return np.minimum(np.floor(np.arange(dst_n) * (1.0 / (dst_n / src_n))),
                          src_n - 1)

    return x[:, _index(rows(h, oh), x.device)][:, :, _index(rows(w, ow), x.device)]


def resize_linear_u8(x: torch.Tensor, out_hw: Sequence[int]) -> torch.Tensor:
    """cv2.resize(..., INTER_LINEAR) of (B, H, W, C) uint8 images, bit-exact:
    OpenCV's fixed-point arithmetic (11-bit weights, an int32 column pass, the
    vertical pass's shifts) in int32 tensor ops."""
    oh, ow = _check_resize(x, out_hw, torch.uint8)
    h, w = x.shape[1:3]
    x0, x1, fx = _linear_taps(w, ow, w / ow, True, clamp=True)
    y0, y1, fy = _linear_taps(h, oh, h / oh, True, clamp=False)
    a0, a1 = _fixed_point(fx)
    b0, b1 = _fixed_point(fy)
    src = x.to(torch.int32)
    cols = (src[:, :, _index(x0, x.device)] * _along(a0, src, 2)
            + src[:, :, _index(x1, x.device)] * _along(a1, src, 2))
    top = (cols[:, _index(y0, x.device)] >> 4) * _along(b0, cols, 1)
    bottom = (cols[:, _index(y1, x.device)] >> 4) * _along(b1, cols, 1)
    return (((top >> 16) + (bottom >> 16) + 2) >> 2).to(torch.uint8)


def _lerp_fma(a: torch.Tensor, b: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """float32(a + (b - a) * f) rounded once at the end, as a fused multiply-add:
    (b - a) * f of two float32 values is exact in float64, the sum is rounded to
    float64 and then to float32 (the same as the fused result unless the float64
    sum lands exactly on a float32 rounding midpoint, a 2**-29 chance)."""
    return (a.double() + (b - a).double() * f.double()).float()


def resize_linear_f32(x: torch.Tensor, out_hw: Sequence[int]) -> torch.Tensor:
    """cv2.resize(..., INTER_LINEAR) of (B, H, W, ...) float32 images, bit-exact
    (the rules above: float64 source positions and a fused lerp per pass, or
    OpenCV's generic path for a source with a side of 1)."""
    oh, ow = _check_resize(x, out_hw, torch.float32)
    h, w = x.shape[1:3]
    generic = min(h, w) == 1
    if generic:
        x0, x1, fx = _linear_taps(w, ow, 1.0 / (ow / w), True, clamp=True)
        y0, y1, fy = _linear_taps(h, oh, 1.0 / (oh / h), True, clamp=False)
    else:
        x0, x1, fx = _linear_taps(w, ow, w / ow, False, clamp=True)
        y0, y1, fy = _linear_taps(h, oh, h / oh, False, clamp=False)

    def lerp(a, b, f, dim):
        f = _along(f, a, dim)
        if generic:
            return a * (1.0 - f) + b * f
        return _lerp_fma(a, b, f)

    cols = lerp(x[:, :, _index(x0, x.device)], x[:, :, _index(x1, x.device)], fx, 2)
    return lerp(cols[:, _index(y0, x.device)], cols[:, _index(y1, x.device)], fy, 1)
