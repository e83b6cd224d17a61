// Per-pixel bounding-box extents of each pixel's 8-connected component.
//
// Replaces the Pallas TPU kernel
// video_classification_tpu/ops/pallas_components.py `_ext_kernel` (entry
// point `component_extents_pallas`): masked min/max propagation of
// (min_row, max_row, min_col, max_col) over the 8-neighbourhood, Jacobi
// (every pixel reads the previous iteration), until nothing changes or
// max_iters (H + W) iterations ran. So each foreground pixel ends with the
// extents of the in-mask pixels within 8-connected geodesic distance
// max_iters; background gets (INT32_MAX, -1, INT32_MAX, -1).
//
// Bound. The work is a chain of dependent iterations (tens to H + W of
// them), each a 3x3 minimum over the mask and a mask-wide "did anything
// change" vote. The bytes (the mask in, 16 per pixel out) and the minima are
// a few microseconds of the card; what costs is the latency of one
// iteration, its loads, minima and synchronisation, times the iteration
// count.
//
// Design.
// - Four fields in one word: byte 0 min_row, byte 1 254 - max_row, byte 2
//   min_col, byte 3 254 - max_col, so all four are byte-wise minima and one
//   __vminu4 updates them together. Background is 0xFFFFFFFF and never wins
//   a minimum (a foreground byte is at most 254, hence H, W <= 255). The
//   outputs are decoded to int32 with the exact sentinels.
// - A thread-block cluster of kCluster CTAs per mask. CTA r owns the strip
//   of rows [r * rows, (r + 1) * rows) in shared memory: two Jacobi buffers
//   of (rows + 2 S) x stride words, the strip with S halo rows above and
//   below (stride: W rounded up to 32 columns, padding background).
// - S iterations per exchange (S = min(kItersPerSync, rows)). At the start
//   of a batch each CTA copies the S rows above and below its strip, which
//   its neighbours sent into its inbox, into its halo rows. Iteration
//   s = 1..S then updates the strip and S - s halo rows on each side (the
//   rows whose inputs are still valid), with a block barrier between
//   iterations. The last batch is clipped so that at most max_iters run.
// - The exchange is point to point, with no cluster-wide barrier in the
//   loop (its release fence is a device-wide memory barrier on this card):
//   after a batch each CTA sends its first and last S rows into its
//   neighbours' inboxes and its change vote (any pixel of its strip changed
//   in the batch) to every CTA of the cluster, by st.async stores into
//   distributed shared memory that complete transactions on the receiver's
//   mbarrier. A CTA starts a batch once its mbarrier has counted every byte
//   it expects; so every CTA reads the same votes and takes the same exit
//   decision, and a batch without a change started from the fixed point.
//   Inboxes, votes and mbarriers have two parities, alternating by batch: a
//   CTA can run at most one batch ahead of a neighbour (it needs that
//   neighbour's vote), so nothing is overwritten before it is read. The
//   last batch sends nothing, and every send is received before its
//   receiver exits.
// - Fixed work per thread: the chunks of 32 columns are a template
//   parameter, so a warp updates a whole row at once (lane l owns the
//   columns l, l + 32, ...) with no division; the 3x3 minimum is separable:
//   a vertical minimum from the rows above and below, then the horizontal
//   one from the neighbouring lanes by shuffles.
// - The words stay in the shared Jacobi buffers, not in registers: a row's
//   vertical minimum needs the rows above and below, which other warps
//   update, and the rows a warp updates shift as the halo region shrinks
//   within a batch, so no thread keeps a fixed set of pixels across
//   iterations. Whether registers would cut the per-iteration latency is
//   not measured.
// - The schedule is fixed at compile time: kCluster = 4 CTAs and
//   kItersPerSync = 4 were the fastest of 1, 4 and 8 CTAs and 1, 2, 4 and 8
//   iterations per exchange on 20 masks of 56x56 and 112x112 on an H100.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSide = 255;
constexpr int kMaxWarps = 16;
constexpr int kCluster = 4;  // CTAs per mask, a portable cluster size (<= 8)
constexpr int kItersPerSync = 4;  // iterations per halo exchange, at most
constexpr uint32_t kBg = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t encode(int y, int x) {
  return (uint32_t)y | (uint32_t)(254 - y) << 8 | (uint32_t)x << 16 |
         (uint32_t)(254 - x) << 24;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The shared::cluster address of local shared address `a` in CTA `rank`.
__device__ __forceinline__ uint32_t remote(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// A 4-byte store into another CTA's shared memory that completes 4 bytes
// of transactions on that CTA's mbarrier `bar`.
__device__ __forceinline__ void send(uint32_t addr, uint32_t v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
      :: "r"(addr), "r"(v), "r"(bar) : "memory");
}

__device__ __forceinline__ void expect_bytes(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t"
      ".reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t"
      "}" :: "r"(bar), "r"(parity) : "memory");
}

// NCH chunks of 32 columns per row, S iterations per exchange (S <= rows).
template <int NCH>
__global__ void __launch_bounds__(kMaxWarps * 32)
extents_cluster_kernel(const uint8_t* __restrict__ masks,
                       int32_t* __restrict__ mnr_out,
                       int32_t* __restrict__ mxr_out,
                       int32_t* __restrict__ mnc_out,
                       int32_t* __restrict__ mxc_out, int H, int W,
                       int max_iters, int rows, int S) {
  constexpr int stride = NCH * 32;
  extern __shared__ uint32_t smem[];
  __shared__ uint64_t bars[2];  // by parity
  __shared__ int votes[2][kCluster];  // by parity, from each CTA
  const int buf = (rows + 2 * S) * stride;  // one Jacobi buffer; row S + y
                                            // holds the strip's row y
  const int box = 2 * S * stride;  // one inbox parity: S rows above, S below
  uint32_t* inbox = smem + 2 * buf;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int rank = (int)cg::this_cluster().block_rank();
  const int y0 = rank * rows;
  const int my_rows = max(0, min(rows, H - y0));
  const size_t plane = (size_t)(blockIdx.x / kCluster) * H * W;
  const uint32_t bar0 = smem_addr(&bars[0]), inbox0 = smem_addr(inbox);
  // Bytes a batch's exchange brings: S rows from each neighbour, and the
  // votes of every CTA after the first batch.
  const uint32_t halo_bytes = ((rank > 0) + (rank < kCluster - 1)) * S * stride * 4;

  for (int i = threadIdx.x; i < 2 * buf + 2 * box; i += blockDim.x) smem[i] = kBg;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar0));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar0 + 8));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // Every CTA of the cluster runs, has filled its memory and set up its
  // mbarriers before any neighbour sends to it.
  cg::this_cluster().sync();

  for (int y = warp; y < my_rows; y += nwarps) {
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int x = lane + 32 * j;
      if (x < W && masks[plane + (size_t)(y0 + y) * W + x])
        smem[(S + y) * stride + x] = encode(y0 + y, x);
    }
  }
  __syncthreads();

  // Sends the strip's first S rows up and last S rows down (background
  // past the mask included, so the byte counts are fixed), and the vote.
  auto exchange = [&](const uint32_t* state, int par, int vote) {
    const uint32_t bar = bar0 + 8 * par, slot = inbox0 + 4 * par * box;
    for (int i = threadIdx.x; i < S * stride; i += blockDim.x) {
      if (rank > 0)
        send(remote(slot + 4 * (S * stride + i), rank - 1), state[S * stride + i],
             remote(bar, rank - 1));
      if (rank < kCluster - 1)
        send(remote(slot + 4 * i, rank + 1), state[rows * stride + i],
             remote(bar, rank + 1));
    }
    if (vote >= 0 && warp == 0 && lane < kCluster)
      send(remote(smem_addr(&votes[par][rank]), lane), (uint32_t)vote,
           remote(bar, lane));
  };
  exchange(smem, 0, -1);

  int cur = 0, changed_cta = 1;
  for (int done = 0, b = 0;; ++b) {
    const int p = b & 1;
    if (b > 0 && done >= max_iters) break;  // the last batch sent nothing
    if (threadIdx.x == 0)
      expect_bytes(bar0 + 8 * p, halo_bytes + (b > 0 ? 4 * kCluster : 0));
    wait_phase(bar0 + 8 * p, (b >> 1) & 1);
    if (b > 0) {
      changed_cta = 0;
      for (int r = 0; r < kCluster; ++r) changed_cta |= votes[p][r];
    }
    if (!changed_cta || done >= max_iters) break;
    const int steps = min(S, max_iters - done);
    {
      const uint32_t* in = inbox + p * box;
      uint32_t* state = smem + cur * buf;
      for (int i = threadIdx.x; i < S * stride; i += blockDim.x) {
        state[i] = in[i];
        state[(S + my_rows) * stride + i] = in[S * stride + i];
      }
      __syncthreads();
    }
    bool changed = false;
    for (int s = 1; s <= steps; ++s) {
      const uint32_t* src = smem + cur * buf;
      uint32_t* dst = smem + (cur ^ 1) * buf;
      for (int y = warp - (steps - s); y < my_rows + steps - s; y += nwarps) {
        const uint32_t* row = src + (S + y) * stride;
        uint32_t w[NCH], v[NCH];
#pragma unroll
        for (int j = 0; j < NCH; ++j) {
          const int x = lane + 32 * j;
          w[j] = row[x];
          v[j] = __vminu4(__vminu4(row[x - stride], w[j]), row[x + stride]);
        }
        const bool mine = y >= 0 && y < my_rows;
#pragma unroll
        for (int j = 0; j < NCH; ++j) {
          uint32_t left = __shfl_up_sync(0xffffffffu, v[j], 1);
          uint32_t right = __shfl_down_sync(0xffffffffu, v[j], 1);
          const uint32_t prev = j > 0 ? __shfl_sync(0xffffffffu, v[j - 1], 31) : kBg;
          const uint32_t after = j + 1 < NCH ? __shfl_sync(0xffffffffu, v[j + 1], 0) : kBg;
          if (lane == 0) left = prev;
          if (lane == 31) right = after;
          if (w[j] != kBg) {
            const uint32_t n = __vminu4(__vminu4(left, v[j]), right);
            changed |= mine && n != w[j];
            dst[(S + y) * stride + lane + 32 * j] = n;
          }
        }
      }
      cur ^= 1;
      if (s < steps) __syncthreads();
    }
    changed_cta = __syncthreads_or(changed);
    done += steps;
    if (done < max_iters) exchange(smem + cur * buf, (b + 1) & 1, changed_cta);
  }

  const uint32_t* state = smem + cur * buf;
  for (int y = warp; y < my_rows; y += nwarps) {
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int x = lane + 32 * j;
      if (x >= W) continue;
      const uint32_t w = state[(S + y) * stride + x];
      const uint32_t b0 = w & 0xFF, b1 = (w >> 8) & 0xFF, b2 = (w >> 16) & 0xFF,
                     b3 = w >> 24;
      const size_t p = plane + (size_t)(y0 + y) * W + x;
      mnr_out[p] = b0 == 0xFF ? INT_MAX : (int32_t)b0;
      mxr_out[p] = b1 == 0xFF ? -1 : 254 - (int32_t)b1;
      mnc_out[p] = b2 == 0xFF ? INT_MAX : (int32_t)b2;
      mxc_out[p] = b3 == 0xFF ? -1 : 254 - (int32_t)b3;
    }
  }
}

struct Shape {
  int B, H, W, rows, S, threads;
  size_t smem;
};

// Rows per CTA, iterations per exchange, threads and shared bytes.
Shape shape_of(int B, int H, int W) {
  Shape s;
  s.B = B;
  s.H = H;
  s.W = W;
  s.rows = (H + kCluster - 1) / kCluster;
  s.S = std::min(kItersPerSync, s.rows);
  s.threads = 32 * std::min(kMaxWarps, s.rows + 2 * (s.S - 1));
  const int stride = (W + 31) / 32 * 32;
  s.smem = (size_t)(2 * (s.rows + 2 * s.S) + 4 * s.S) * stride * 4;
  return s;
}

template <int NCH>
cudaError_t launch_nch(const Shape& s, const uint8_t* masks, int32_t* mnr,
                       int32_t* mxr, int32_t* mnc, int32_t* mxc, int max_iters,
                       cudaStream_t st) {
  auto kernel = extents_cluster_kernel<NCH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)s.B * kCluster);
  cfg.blockDim = dim3(s.threads);
  cfg.dynamicSmemBytes = s.smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, masks, mnr, mxr, mnc, mxc, s.H, s.W,
                           max_iters, s.rows, s.S);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// Launches kCluster CTAs per mask on `st`; masks are (B, H, W) bytes, 0 for
// background, and each output is (B, H, W) int32.
cudaError_t component_extents_launch(const uint8_t* masks, int32_t* mnr,
                                     int32_t* mxr, int32_t* mnc, int32_t* mxc,
                                     int B, int H, int W, int max_iters,
                                     cudaStream_t st) {
  if (B <= 0 || H <= 0 || W <= 0 || H > kMaxSide || W > kMaxSide)
    return cudaErrorInvalidValue;
  const Shape s = shape_of(B, H, W);
  switch ((W + 31) / 32) {
    case 1: return launch_nch<1>(s, masks, mnr, mxr, mnc, mxc, max_iters, st);
    case 2: return launch_nch<2>(s, masks, mnr, mxr, mnc, mxc, max_iters, st);
    case 3: return launch_nch<3>(s, masks, mnr, mxr, mnc, mxc, max_iters, st);
    case 4: return launch_nch<4>(s, masks, mnr, mxr, mnc, mxc, max_iters, st);
    case 5: return launch_nch<5>(s, masks, mnr, mxr, mnc, mxc, max_iters, st);
    case 6: return launch_nch<6>(s, masks, mnr, mxr, mnc, mxc, max_iters, st);
    case 7: return launch_nch<7>(s, masks, mnr, mxr, mnc, mxc, max_iters, st);
    case 8: return launch_nch<8>(s, masks, mnr, mxr, mnc, mxc, max_iters, st);
    default: return cudaErrorInvalidValue;
  }
}
