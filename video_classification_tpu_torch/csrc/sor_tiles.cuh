// The red-black SOR half-sweeps of the flow solver in on-chip tiles, shared
// by the per-op solve (sor_solve.cu, K4) and the fused level (flow_level.cu,
// K1).
//
// A tile is a window of one frame pair: its interior plus a halo of
// kHalfSweeps pixels on each side, clipped to the frame, at most
// kTileH x kTileW (a frame that fits one window is one tile with no halo).
// A block keeps the tile's 11 read-only fields of the normal equations
// (a12, b1, b2, wu, wd, wl, wr, inv_u, inv_v, nuc, nvc) in registers and
// its increments (du, dv) in shared memory, runs up to kHalfSweeps
// half-sweeps there, one __syncthreads() apart, and writes back the interior
// only. After half-sweep j (1-based) a pixel is exact if it lies at least j
// pixels inside every window edge that is not a frame edge, so each
// half-sweep updates only that shrinking region: it never reads past the
// window, and the interior is exact after the last. Neighbours outside the
// frame are 0, as in the plain twin; neighbours outside the window but
// inside the frame are never needed.
//
// Overlapping windows read halos that neighbouring tiles rewrite in the same
// launch, so a launch reads (du, dv) from one buffer and writes another; the
// launchers alternate two buffers so that the last launch lands in the
// result.
//
// The blocks are persistent, one per SM, each walking every gridDim.x-th
// tile. Shared memory holds a staging copy of the next tile's 11 fields
// (176 KB), filled by cp.async while the current tile computes from
// registers, and the current tile's (du, dv) (32 KB): the loads of one tile
// overlap the half-sweeps of the previous one.
//
// Layout: a field is stored split by colour, cell (y, x) of colour
// (y0 + x0 + y + x) & 1 at [colour][y][x / 2] with a row pitch of
// kTileW / 2 = 32 cells: lane l of a warp owns cell l of its rows, and the
// neighbours a warp reads lie on consecutive words. Thread (warp w, lane l)
// owns the cells of rows w + kWarps * i, i < kRows, in both colours.
//
// The arithmetic is the plain twin's (ops/sor_solve.py::sor_solve_reference),
// in its order, with its fused multiply-adds as __fmaf_rn (XLA:CPU's, see
// ops/fma.py); the files that include this one are built with -fmad=false,
// so nvcc contracts nothing else.

#pragma once

#include <cuda_runtime.h>

namespace sor_tiles {

// The schedule. ops/sor_solve.py holds the same numbers and passes them in;
// the bindings refuse a call whose numbers differ.
constexpr int kTileH = 64;       // window rows, halo included
constexpr int kTileW = 64;       // window columns, halo included
constexpr int kHalfSweeps = 12;  // half-sweeps per tiled launch = halo

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kTileH / kWarps;  // rows a thread owns
constexpr int kPitch = kTileW / 2;      // cells of one colour in a row
constexpr int kPlane = kTileH * kPitch;
static_assert(kPitch == 32 && kTileH % kWarps == 0, "a lane per cell");
static_assert(kHalfSweeps % 2 == 0, "launches start on red");

// Source fields, each (B, H, W) float32; DU and DV are the launch's source
// increments.
enum Field { A12, B1, B2, WU, WD, WL, WR, INVU, INVV, NUC, NVC, DU, DV,
             kFields };
constexpr int kCoeffs = DU;  // the read-only fields
// Staging (kCoeffs fields) and the current (du, dv), two colours each.
constexpr int kSmemBytes = (kCoeffs + 2) * 2 * kPlane * (int)sizeof(float);

struct Fields {
  const float* f[kFields];
};

struct Plan {
  int halo;             // 0 for a whole frame
  int ih, iw;           // interior of a tile
  int tiles_y, tiles_x;
  int per_launch;       // half-sweeps per launch (a whole frame: all)
};

inline bool whole_frame(int H, int W) { return H <= kTileH && W <= kTileW; }

inline Plan plan(int H, int W, int n_half) {
  Plan p;
  if (whole_frame(H, W)) {
    p.halo = 0;
    p.ih = H;
    p.iw = W;
    p.per_launch = n_half > 0 ? n_half : 2;
  } else {
    p.halo = kHalfSweeps;
    p.ih = kTileH - 2 * kHalfSweeps;
    p.iw = kTileW - 2 * kHalfSweeps;
    p.per_launch = kHalfSweeps;
  }
  p.tiles_y = (H + p.ih - 1) / p.ih;
  p.tiles_x = (W + p.iw - 1) / p.iw;
  return p;
}

// Persistent blocks of a launch: one per SM, at most one per tile.
inline int grid_blocks(const Plan& P, int B) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int total = B * P.tiles_y * P.tiles_x;
  return total < sms ? total : sms;
}

// A tile's interior [iy0, iy1) x [ix0, ix1) and its window [wy0, wy1) x
// [wx0, wx1).
struct Window {
  int iy0, iy1, ix0, ix1, wy0, wy1, wx0, wx1;
};

__device__ __forceinline__ Window window(const Plan& P, int tile, int H,
                                         int W) {
  Window w;
  const int ty = tile / P.tiles_x, tx = tile - ty * P.tiles_x;
  w.iy0 = ty * P.ih;
  w.ix0 = tx * P.iw;
  w.iy1 = min(w.iy0 + P.ih, H);
  w.ix1 = min(w.ix0 + P.iw, W);
  w.wy0 = max(w.iy0 - P.halo, 0);
  w.wx0 = max(w.ix0 - P.halo, 0);
  w.wy1 = min(w.iy1 + P.halo, H);
  w.wx1 = min(w.ix1 + P.halo, W);
  return w;
}

__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for all but the newest `pending` groups of copies.
template <int pending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// Starts copying rows y0 .. y1 - 1 of fields f0 .. f0 + nf - 1 of window w
// of pair b into dst, split by colour.
__device__ __forceinline__ void copy_window(float* dst, const Fields& F,
                                            int f0, int nf, const Window& w,
                                            int b, int H, int W, int y0,
                                            int y1) {
  const int WW = w.wx1 - w.wx0, par = (w.wy0 + w.wx0) & 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t base = (size_t)b * H * W;
  for (int y = y0 + warp; y < y1; y += kWarps) {
    for (int x = lane; x < WW; x += 32) {
      const size_t g = base + (size_t)(w.wy0 + y) * W + w.wx0 + x;
      const int c = ((y + x + par) & 1) * kPlane + y * kPitch + (x >> 1);
      for (int f = 0; f < nf; ++f)
        copy_async(dst + f * 2 * kPlane + c, F.f[f0 + f] + g);
    }
  }
}

// The region a half-sweep updates: rows [y0, y1), columns [x0, x1) of the
// window.
struct Region {
  int y0, y1, x0, x1;
};

__device__ __forceinline__ Region region(const Window& w, int d, int H,
                                         int W) {
  const int WH = w.wy1 - w.wy0, WW = w.wx1 - w.wx0;
  return {w.wy0 > 0 ? d : 0, w.wy1 < H ? WH - d : WH, w.wx0 > 0 ? d : 0,
          w.wx1 < W ? WW - d : WW};
}

// wu*up + wd*dn + wl*lf + wr*rt with XLA:CPU's fused multiply-adds
// (ops/sor_solve.py::weighted_sum); shared with the hoisted fields of
// sor_solve.cu and flow_level.cu.
__device__ __forceinline__ float weighted_sum(float wu, float wd, float wl,
                                              float wr, float up, float dn,
                                              float lf, float rt) {
  return __fmaf_rn(wr, rt, __fmaf_rn(wl, lf, __fmaf_rn(wu, up, wd * dn)));
}

__device__ __forceinline__ float weighted_sum(const float* k, float up,
                                              float dn, float lf, float rt) {
  return weighted_sum(k[WU], k[WD], k[WL], k[WR], up, dn, lf, rt);
}

// One increment's over-relaxed update (ops/sor_solve.py::relax):
// new = fma(alpha, s, fma(-a12, d_other, b)) * inv, then
// fma(omega, new, (1 - omega) * d).
__device__ __forceinline__ float relax(float d, float d_other, float b,
                                       float a12, float s, float inv,
                                       float alpha, float omega,
                                       float one_m_omega) {
  const float nw = __fmaf_rn(alpha, s, __fmaf_rn(-a12, d_other, b)) * inv;
  return __fmaf_rn(omega, nw, one_m_omega * d);
}

// The hoisted reciprocal diagonal 1 / (a + alpha * wsum) and constant
// smoothness term neighbour(f) - wsum * f (ops/sor_solve.py::hoisted).
__device__ __forceinline__ float inv_diagonal(float a, float alpha,
                                              float wsum) {
  return 1.f / __fmaf_rn(alpha, wsum, a);
}

__device__ __forceinline__ float smoothness_constant(float neighbour,
                                                     float wsum, float f) {
  return __fmaf_rn(-wsum, f, neighbour);
}

// One half-sweep of colour kCol over region r: each thread updates its
// cells of that colour, du then dv with the new du.
template <int kCol>
__device__ __forceinline__ void half_sweep(
    float* __restrict__ work, const float (&cf)[kRows][2][kCoeffs],
    const Region& r, int WH, int WW, int par, float alpha, float omega,
    float one_m_omega) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* own_du = work + kCol * kPlane;
  float* own_dv = work + (2 + kCol) * kPlane;
  const float* nb_du = work + (1 - kCol) * kPlane;
  const float* nb_dv = work + (3 - kCol) * kPlane;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int y = warp + kWarps * i;
    const int x = 2 * lane + ((y + par + kCol) & 1);
    if (y < r.y0 || y >= r.y1 || x < r.x0 || x >= r.x1) continue;
    const float* k = cf[i][kCol];
    const int c = y * kPitch + lane;
    const int up = c - kPitch, dn = c + kPitch;
    const int lf = y * kPitch + ((x - 1) >> 1);
    const int rt = y * kPitch + ((x + 1) >> 1);
    const float du_c = own_du[c], dv_c = own_dv[c];

    const float du_up = y > 0 ? nb_du[up] : 0.f;
    const float du_dn = y < WH - 1 ? nb_du[dn] : 0.f;
    const float du_lf = x > 0 ? nb_du[lf] : 0.f;
    const float du_rt = x < WW - 1 ? nb_du[rt] : 0.f;
    const float su = k[NUC] + weighted_sum(k, du_up, du_dn, du_lf, du_rt);
    const float du_n =
        relax(du_c, dv_c, k[B1], k[A12], su, k[INVU], alpha, omega,
              one_m_omega);

    const float dv_up = y > 0 ? nb_dv[up] : 0.f;
    const float dv_dn = y < WH - 1 ? nb_dv[dn] : 0.f;
    const float dv_lf = x > 0 ? nb_dv[lf] : 0.f;
    const float dv_rt = x < WW - 1 ? nb_dv[rt] : 0.f;
    const float sv = k[NVC] + weighted_sum(k, dv_up, dv_dn, dv_lf, dv_rt);
    own_du[c] = du_n;
    own_dv[c] = relax(dv_c, du_n, k[B2], k[A12], sv, k[INVV], alpha, omega,
                      one_m_omega);
  }
}

// One launch: n half-sweeps (n even, red first) of every tile of the pairs
// b with active(b), from F's (du, dv) into (du_out, dv_out). s is the
// block's dynamic shared memory (kSmemBytes).
template <class Active>
__device__ __forceinline__ void run_tiles(
    float* __restrict__ s, const Fields& F, float* __restrict__ du_out,
    float* __restrict__ dv_out, const Plan& P, int B, int H, int W, int n,
    float alpha, float omega, float one_m_omega, Active active) {
  const int tiles = P.tiles_y * P.tiles_x, total = B * tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* work = s + kCoeffs * 2 * kPlane;
  auto next_tile = [&](int id) {
    while (id < total && !active(id / tiles)) id += gridDim.x;
    return id;
  };
  auto tile_window = [&](int id) {
    return window(P, id - (id / tiles) * tiles, H, W);
  };

  int id = next_tile(blockIdx.x);
  if (id < total) {
    const Window w = tile_window(id);
    copy_window(s, F, 0, kCoeffs, w, id / tiles, H, W, 0, w.wy1 - w.wy0);
  }
  commit_copies();
  while (id < total) {
    const int b = id / tiles;
    const Window w = tile_window(id);
    const int WH = w.wy1 - w.wy0, WW = w.wx1 - w.wx0;
    const int par = (w.wy0 + w.wx0) & 1;
    copy_window(work, F, DU, 2, w, b, H, W, 0, WH);
    commit_copies();
    wait_copies<1>();  // this tile's staged fields
    __syncthreads();
    float cf[kRows][2][kCoeffs];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int f = 0; f < kCoeffs; ++f)
          cf[i][c][f] =
              s[(f * 2 + c) * kPlane + (warp + kWarps * i) * kPitch + lane];
    wait_copies<0>();  // this tile's (du, dv)
    __syncthreads();   // and the staging buffer is free

    // The next tile's fields are staged a slice of rows per pair of
    // half-sweeps, so that its copies spread over this tile's compute.
    const int next = next_tile(id + gridDim.x);
    const Window nw = tile_window(next < total ? next : id);
    const int nh = next < total ? nw.wy1 - nw.wy0 : 0;
    const int slice = (nh + n / 2 - 1) / (n / 2);
    for (int j = 0; j < n; j += 2) {
      const int y0 = j / 2 * slice;
      copy_window(s, F, 0, kCoeffs, nw, next / tiles, H, W, min(y0, nh),
                  min(y0 + slice, nh));
      half_sweep<0>(work, cf, region(w, j + 1, H, W), WH, WW, par, alpha,
                    omega, one_m_omega);
      __syncthreads();
      half_sweep<1>(work, cf, region(w, j + 2, H, W), WH, WW, par, alpha,
                    omega, one_m_omega);
      __syncthreads();
    }
    commit_copies();

    const size_t base = (size_t)b * H * W;
    for (int y = w.iy0 - w.wy0 + warp; y < w.iy1 - w.wy0; y += kWarps) {
      for (int x = w.ix0 - w.wx0 + lane; x < w.ix1 - w.wx0; x += 32) {
        const size_t g = base + (size_t)(w.wy0 + y) * W + w.wx0 + x;
        const int c = ((y + x + par) & 1) * kPlane + y * kPitch + (x >> 1);
        du_out[g] = work[c];
        dv_out[g] = work[2 * kPlane + c];
      }
    }
    __syncthreads();  // the next tile's copies overwrite (du, dv)
    id = next;
  }
  wait_copies<0>();
}

// Launches of a solve of n_half half-sweeps: ceil(n_half / per_launch).
inline int num_launches(const Plan& P, int n_half) {
  return (n_half + P.per_launch - 1) / P.per_launch;
}

// Runs n_half half-sweeps over all B pairs as a sequence of launches of
// `launch(src_du, src_dv, dst_du, dst_dv, n)`: src is (du0, dv0) for the
// first, the previous destination after; destinations alternate between
// (du, dv) and (du2, dv2) so that the last is (du, dv). (du0, dv0) must not
// be the first destination: (du2, dv2) when the launch count is even, else
// (du, dv). Returns the first launch error. n_half == 0 launches nothing.
template <class Launch>
cudaError_t run_schedule(const Plan& P, int n_half, const float* du0,
                         const float* dv0, float* du, float* dv, float* du2,
                         float* dv2, Launch launch) {
  const int launches = num_launches(P, n_half);
  const float *src_du = du0, *src_dv = dv0;
  for (int i = 0; i < launches; ++i) {
    const bool last_parity = (launches - 1 - i) % 2 == 0;
    float* dst_du = last_parity ? du : du2;
    float* dst_dv = last_parity ? dv : dv2;
    const int left = n_half - i * P.per_launch;
    launch(src_du, src_dv, dst_du, dst_dv,
           left < P.per_launch ? left : P.per_launch);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src_du = dst_du;
    src_dv = dst_dv;
  }
  return cudaSuccess;
}

}  // namespace sor_tiles
