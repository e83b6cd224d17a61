// The red-black SOR half-sweeps of the fused flow level (flow_level.cu, K1)
// with the frame resident on the chip for a whole outer: one launch runs all
// 2 n_sor half-sweeps of every active pair.
//
// Each (pair, level) frame is held by one thread-block cluster. The frame
// is cut into strips of `rows` rows, one strip per CTA (the last may be
// shorter). A CTA loads its strip's read-only fields into shared memory
// once, keeps its increments (du, dv) there with one halo row above and one
// below, and writes its strip of (du, dv) back once, after the last
// half-sweep.
//
// The fields on the chip are 9 of the level's 11: a12, b1, b2, wl, inv_u,
// inv_v, nuc, nvc and wu, with wu's row below the strip. The other two are
// read off these: the weight down of (y, x) is the weight up of (y + 1, x)
// and the weight right of (y, x) the weight left of (y, x + 1), both
// 0.5 * (phi + phi') of the same two values (float addition commutes), and
// 0 past the frame, where the coefficient kernel writes 0 too.
//
// The exchange, in every half-sweep but the last: a half-sweep of colour c
// rewrites the strip's cells of colour c, and the next one (colour 1 - c)
// reads, in the strip's first and last rows, the colour-c cells of the rows
// across the strip's edges. So each thread that updates a cell of the
// strip's first row sends it into the bottom halo row of the CTA above, and
// one of the last row into the top halo row of the CTA below, as soon as it
// is computed, by st.async stores into distributed shared memory that
// complete transactions on the receiver's mbarrier (cluster_strips.cuh's
// helpers); a CTA starts a half-sweep once its mbarrier has counted the
// bytes of the previous one's edge rows. The edge rows are updated first,
// so their sends overlap the rest of the half-sweep. No halo cell is
// overwritten while it may be read: only edge cells read the halo, each
// before it is sent; the colour-c halo cells are read only in half-sweeps
// of colour 1 - c; and the neighbour sends the next colour-c cells only
// after it has counted every edge cell of that half-sweep. For the same
// reason a CTA runs at most one half-sweep ahead of a neighbour, so two
// mbarriers, by the parity of the half-sweep whose cells they carry,
// suffice. Every send is received before its receiver exits: the last
// half-sweep sends nothing.
//
// One exchange row per half-sweep (s = 1): a wider halo would recompute s -
// 1 rows on each side per exchange and hold their fields, and at 240x320
// the strip's fields already fill the SM's shared memory.
//
// The increments start from 0 in every outer (K1's SOR is cold), so the
// halo rows start as the neighbours' cells do, and no exchange precedes the
// first half-sweep. Neighbours outside the frame are 0, as in the plain
// twin.
//
// The arithmetic is the SOR tiles' (sor_tiles.cuh: weighted_sum, relax),
// cell by cell in the same order; a red-black half-sweep's result does not
// depend on the order of the cells within a colour, so the result is the
// tiled schedule's, bit for bit.
//
// Layout: as in sor_tiles.cuh a field is stored split by colour, but by
// rows: the colour-c cells of local row r at [(2 r + c) * pitch + x / 2],
// pitch = ceil(W / 2), so consecutive threads' cells and their up, down,
// left and right neighbours lie on consecutive words. A half-sweep's cells,
// rows x pitch of them, are dealt out flat, thread t taking t, t + kThreads,
// ... (at most kCells), with the rows in the order 0, rows - 1, 1, ...: a
// warp's lanes never idle past the end of a row whose pitch is not a
// multiple of 32.
//
// The plan (ops/flow_level.py::resident_plan mirrors it): the fewest CTAs,
// at most kMaxCluster, whose strips' 2 pitch (kCoeffs rows + 1 + 2 (rows +
// 2)) words fit one CTA's shared memory (and rows x pitch kCells cells a
// thread); none, and the tiled schedule, where even kMaxCluster do not fit.
// Where the fewest are more than 8, the portable cluster size, the cluster
// takes a GPC (16-18 SMs) of its own and only one fits it, so it takes
// kMaxCluster CTAs' shorter strips: at 180x240, 15 CTAs of 12 rows run in
// 7 clusters at once, 9 of 20 rows in 9 (cudaOccupancyMaxActiveClusters on
// an H100), 11.3 ms a 101-pair level against 14.0.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "cluster_strips.cuh"
#include "sor_tiles.cuh"

namespace sor_resident {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;   // CTAs per frame, at most
constexpr int kMaxSmem = 232448;  // shared memory of one H100 block
constexpr int kStaticSmem = 16;   // the two mbarriers
constexpr int kCoeffs = 9;        // fields on the chip
constexpr int kCells = 6;         // cells of one colour a thread updates

// The fields on the chip, in their order in shared memory; WU last, with
// one row more than the others.
enum Coeff { A12, B1, B2, WL, INVU, INVV, NUC, NVC, WU };
static_assert(WU + 1 == kCoeffs, "WU is the last field");

struct Plan {
  int cluster;  // CTAs per frame; 0 where no cluster holds the frame
  int rows;     // rows per CTA
};

__host__ __device__ inline int pitch(int W) { return (W + 1) / 2; }

// Dynamic shared memory of a CTA holding `rows` rows of width W.
inline size_t smem_bytes(int rows, int W) {
  return (size_t)2 * pitch(W) * (kCoeffs * rows + 1 + 2 * (rows + 2)) *
         sizeof(float);
}

// Whether a strip's cells of one colour (rows x pitch at most) fit kCells
// cells a thread.
inline bool cells_fit(int rows, int W) {
  return rows * pitch(W) <= kCells * kThreads;
}

inline Plan plan(int H, int W) {
  for (int c = 1; c <= kMaxCluster; ++c) {
    int rows = (H + c - 1) / c;
    if (smem_bytes(rows, W) + kStaticSmem <= (size_t)kMaxSmem &&
        cells_fit(rows, W)) {
      // A cluster past the portable 8 CTAs takes a GPC of its own (16-18
      // SMs on an H100), so it takes kMaxCluster CTAs' strips.
      if (c > kMaxCluster / 2) rows = (H + kMaxCluster - 1) / kMaxCluster;
      return {(H + rows - 1) / rows, rows};
    }
  }
  return {0, 0};
}

struct Args {
  const float* f[kCoeffs];  // (B, H, W) fields in Coeff order
  float* du;                // (B, H, W) results
  float* dv;
  int H, W, rows, n;        // n: half-sweeps, red first
  float alpha, omega, one_m_omega;
};

// The kernel body: block b is CTA b % cluster of the cluster of pair
// b / cluster; pairs with !active(pair) return at once, their whole
// cluster with them. s is the block's dynamic shared memory
// (smem_bytes(rows, W)).
template <class Active>
__device__ __forceinline__ void run(float* __restrict__ s, const Args& a,
                                    Active active) {
  using cluster_strips::detail::expect_bytes;
  using cluster_strips::detail::remote;
  using cluster_strips::detail::send;
  using cluster_strips::detail::smem_addr;
  using cluster_strips::detail::wait_phase;
  namespace cg = cooperative_groups;
  __shared__ uint64_t bars[2];  // by the parity of the half-sweep sent

  const cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int pair = blockIdx.x / C;
  if (!active(pair)) return;  // uniform over the cluster

  const int H = a.H, W = a.W, R = a.rows, P = pitch(W);
  const int y0 = rank * R, my = min(R, H - y0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int plane = 2 * R * P;             // one field of R rows
  float* const cf = s;                     // field f < WU at cf + f * plane
  float* const wu = s + WU * plane;        // R + 1 rows
  float* const du = wu + 2 * (R + 1) * P;  // R + 2 rows, row 0 the halo above
  float* const dv = du + 2 * (R + 2) * P;
  const int words = 2 * P * (kCoeffs * R + 1 + 2 * (R + 2));
  const uint32_t bar0 = smem_addr(&bars[0]);

  for (int i = threadIdx.x; i < words; i += kThreads) s[i] = 0.f;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar0));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar0 + 8));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the zeros land before the fields

  // The strip's fields, and wu's row below the strip (0 past the frame).
  const size_t base = (size_t)pair * H * W;
  for (int r = warp; r <= my && y0 + r < H; r += kWarps) {
    const int y = y0 + r;
    for (int x = lane; x < W; x += 32) {
      const size_t g = base + (size_t)y * W + x;
      const int at = (2 * r + ((y + x) & 1)) * P + (x >> 1);
      wu[at] = a.f[WU][g];
      if (r < my)
        for (int f = 0; f < WU; ++f) cf[f * plane + at] = a.f[f][g];
    }
  }

  // This thread's cells, as local row << 16 | index in the row's colour
  // plane; -1 past the strip. The rows in the order 0, my - 1, 1, ...,
  // my - 2: the edge rows, whose cells go to the neighbours, first.
  int cell[kCells];
#pragma unroll
  for (int m = 0; m < kCells; ++m) {
    const int i = threadIdx.x + m * kThreads, t = i / P;
    const int r = t == 0 ? 0 : t == 1 ? my - 1 : t - 1;
    cell[m] = t < my ? r << 16 | (i - t * P) : -1;
  }
  // Every CTA of the cluster has loaded and set up its mbarriers before a
  // neighbour sends to it.
  cluster.sync();

  const bool has_up = rank > 0, has_dn = rank < C - 1;
  // The colour-c cells of row y.
  auto row_cells = [&](int y, int c) { return (W - ((y + c) & 1) + 1) / 2; };
  const uint32_t du_at = smem_addr(du), dv_at = smem_addr(dv);
  const float alpha = a.alpha, omega = a.omega, one_m_omega = a.one_m_omega;
  for (int j = 0; j < a.n; ++j) {
    const int c = j & 1, nc = c ^ 1;
    if (j > 0 && (has_up || has_dn)) {  // the previous half-sweep's edges
      const uint32_t bar = bar0 + 8 * ((j - 1) & 1);
      if (threadIdx.x == 0)
        expect_bytes(bar, 2 * sizeof(float) *
                              ((has_up ? row_cells(y0 - 1, nc) : 0) +
                               (has_dn ? row_cells(y0 + R, nc) : 0)));
      wait_phase(bar, ((j - 1) >> 1) & 1);
    }
    const bool sends = j + 1 < a.n;
    const uint32_t bar = bar0 + 8 * (j & 1);
#pragma unroll
    for (int m = 0; m < kCells; ++m) {
      if (cell[m] < 0) break;
      const int r = cell[m] >> 16, k = cell[m] & 0xffff;
      const int y = y0 + r, x = 2 * k + ((y + c) & 1);
      if (x >= W) continue;
      const int own = (2 * r + c) * P, side = (2 * r + nc) * P;
      const int st = own + 2 * P, nb = side + 2 * P;  // (du, dv) row r + 1
      const int up = side, dn = side + 4 * P;          // rows r and r + 2
      const int lf = nb + ((x - 1) >> 1), rt = nb + ((x + 1) >> 1);
      const int at = own + k;
      const float w_u = wu[at], w_d = wu[nb + k];  // wu's row r + 1
      const float w_l = cf[WL * plane + at];
      const float w_r =
          x < W - 1 ? cf[WL * plane + side + ((x + 1) >> 1)] : 0.f;
      const float a12 = cf[A12 * plane + at];
      const float du_c = du[st + k], dv_c = dv[st + k];

      const float du_up = y > 0 ? du[up + k] : 0.f;
      const float du_dn = y < H - 1 ? du[dn + k] : 0.f;
      const float du_lf = x > 0 ? du[lf] : 0.f;
      const float du_rt = x < W - 1 ? du[rt] : 0.f;
      const float su =
          cf[NUC * plane + at] + sor_tiles::weighted_sum(w_u, w_d, w_l, w_r,
                                                         du_up, du_dn, du_lf,
                                                         du_rt);
      const float du_n =
          sor_tiles::relax(du_c, dv_c, cf[B1 * plane + at], a12, su,
                           cf[INVU * plane + at], alpha, omega, one_m_omega);

      const float dv_up = y > 0 ? dv[up + k] : 0.f;
      const float dv_dn = y < H - 1 ? dv[dn + k] : 0.f;
      const float dv_lf = x > 0 ? dv[lf] : 0.f;
      const float dv_rt = x < W - 1 ? dv[rt] : 0.f;
      const float sv =
          cf[NVC * plane + at] + sor_tiles::weighted_sum(w_u, w_d, w_l, w_r,
                                                         dv_up, dv_dn, dv_lf,
                                                         dv_rt);
      const float dv_n =
          sor_tiles::relax(dv_c, du_n, cf[B2 * plane + at], a12, sv,
                           cf[INVV * plane + at], alpha, omega, one_m_omega);
      du[st + k] = du_n;
      dv[st + k] = dv_n;
      // An edge cell goes at once into the halo row R + 1 of the CTA above
      // or the halo row 0 of the CTA below (a CTA with a CTA below holds R
      // rows).
      if (sends && r == 0 && has_up) {
        const uint32_t to = 4 * ((2 * (R + 1) + c) * P + k);
        send(remote(du_at + to, rank - 1), __float_as_uint(du_n),
             remote(bar, rank - 1));
        send(remote(dv_at + to, rank - 1), __float_as_uint(dv_n),
             remote(bar, rank - 1));
      }
      if (sends && r == my - 1 && has_dn) {
        const uint32_t to = 4 * (c * P + k);
        send(remote(du_at + to, rank + 1), __float_as_uint(du_n),
             remote(bar, rank + 1));
        send(remote(dv_at + to, rank + 1), __float_as_uint(dv_n),
             remote(bar, rank + 1));
      }
    }
    __syncthreads();
  }

  for (int r = warp; r < my; r += kWarps) {
    const int y = y0 + r;
    for (int x = lane; x < W; x += 32) {
      const size_t g = base + (size_t)y * W + x;
      const int at = (2 * (r + 1) + ((y + x) & 1)) * P + (x >> 1);
      a.du[g] = du[at];
      a.dv[g] = dv[at];
    }
  }
}

}  // namespace sor_resident
