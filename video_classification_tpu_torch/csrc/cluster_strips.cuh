// Masked 8-neighbour Jacobi minimum propagation over a batch of masks, shared
// by the component extents (component_extents.cu, K2) and the component
// labels (label_components.cu, K6).
//
// Every foreground pixel starts with a 32-bit word; each iteration it takes
// the minimum of its word and its 8 neighbours' words of the previous
// iteration (Jacobi), until an iteration changes nothing or max_iters ran.
// Background and the padding past the mask hold a sentinel that never wins a
// minimum and is never rewritten, so the masked 3x3 minimum is separable.
// A word policy P says what a word is:
//   kPasses     independent propagations per mask (a cluster each, stopping
//               on their own), pass 0 .. kPasses - 1;
//   kMaxChunks  the widest row of the cluster route, in chunks of 32;
//   kBg         the background word;
//   encode(pass, y, x, W)  the word of foreground pixel (y, x);
//   min(a, b)   the per-neighbour minimum;
//   decode(pass, w, out, p)  writes word w of pixel p into the int32 outputs.
//
// Bound. The work is a chain of dependent iterations (tens to H + W of
// them), each a 3x3 minimum over the mask and a mask-wide "did anything
// change" vote. The bytes (the mask in, the outputs out) and the minima are
// a few microseconds of the card; what costs is the latency of one
// iteration, its loads, minima and synchronisation, times the iteration
// count.
//
// The cluster route, for masks whose strips fit shared memory:
// - A thread-block cluster of kCluster CTAs per mask and pass. CTA r owns
//   the strip of rows [r * rows, (r + 1) * rows) in shared memory: two
//   Jacobi buffers of (rows + 2 S) x stride words, the strip with S halo rows
//   above and below (stride: W rounded up to 32 columns, padding background).
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
//   iterations per exchange on 20 masks of 56x56 and 112x112 on an H100
//   (K2's byte words).
//
// The device-memory route, for masks whose strips do not fit (or rows wider
// than kMaxChunks chunks): one launch per iteration over every pixel of
// the batch, a warp per 32 columns of a row taking the same separable
// minimum, both Jacobi buffers in device memory, and a change flag per
// mask and pass that the next launch reads, so a propagation that reached
// its fixed point skips the rest. The iteration that finds no change wrote
// its input again, so both buffers then hold the fixed point, and the
// result is read from the buffer of the last iteration that could run.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace cluster_strips {

constexpr int kMaxWarps = 16;
constexpr int kThreads = kMaxWarps * 32;
constexpr int kCluster = 4;  // CTAs per mask, a portable cluster size (<= 8)
constexpr int kItersPerSync = 4;  // iterations per halo exchange, at most
constexpr int kMaxSmem = 232448;  // shared memory of one H100 block
constexpr int kStaticSmem = 2 * 8 + 2 * kCluster * 4;  // mbarriers and votes
// The device-memory route's blocks: kDeviceWarps warps over kDeviceBlockRows
// rows of 32 columns (fewer, fuller blocks keep a launch whose masks all
// reached their fixed point short).
constexpr int kDeviceWarps = 8;
constexpr int kDeviceThreads = kDeviceWarps * 32;
constexpr int kDeviceBlockRows = 64;

// One launch's masks ((B, H, W) bytes, 0 for background) and int32 outputs
// (each (B, H, W); the policy says which it writes).
struct Args {
  const uint8_t* masks;
  int32_t* out[4];
  int H, W, max_iters;
  int rows, S;      // the cluster route's strip rows and iterations per exchange
  uint32_t* words;  // the device-memory route's buffers: 2 x planes x H x W
  int* flags;       // its change flags: 3 x planes
  int planes;       // B x kPasses
};

namespace detail {

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

}  // namespace detail

// The cluster route's kernel body: NCH chunks of 32 columns per row, S
// iterations per exchange (S <= rows). Block b is CTA b % kCluster of the
// cluster of mask b / (kCluster kPasses), pass (b / kCluster) % kPasses.
template <class P, int NCH>
__device__ __forceinline__ void propagate(const Args& a) {
  using detail::remote;
  using detail::send;
  using detail::smem_addr;
  constexpr uint32_t kBg = P::kBg;
  constexpr int stride = NCH * 32;
  extern __shared__ uint32_t smem[];
  __shared__ uint64_t bars[2];  // by parity
  __shared__ int votes[2][kCluster];  // by parity, from each CTA
  const int H = a.H, W = a.W, max_iters = a.max_iters, rows = a.rows, S = a.S;
  const int buf = (rows + 2 * S) * stride;  // one Jacobi buffer; row S + y
                                            // holds the strip's row y
  const int box = 2 * S * stride;  // one inbox parity: S rows above, S below
  uint32_t* inbox = smem + 2 * buf;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int rank = (int)cooperative_groups::this_cluster().block_rank();
  const int y0 = rank * rows;
  const int my_rows = max(0, min(rows, H - y0));
  const int cluster = blockIdx.x / kCluster;
  const int pass = cluster % P::kPasses;
  const size_t plane = (size_t)(cluster / P::kPasses) * H * W;
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
  cooperative_groups::this_cluster().sync();

  for (int y = warp; y < my_rows; y += nwarps) {
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int x = lane + 32 * j;
      if (x < W && a.masks[plane + (size_t)(y0 + y) * W + x])
        smem[(S + y) * stride + x] = P::encode(pass, y0 + y, x, W);
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
      detail::expect_bytes(bar0 + 8 * p, halo_bytes + (b > 0 ? 4 * kCluster : 0));
    detail::wait_phase(bar0 + 8 * p, (b >> 1) & 1);
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
          v[j] = P::min(P::min(row[x - stride], w[j]), row[x + stride]);
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
            const uint32_t n = P::min(P::min(left, v[j]), right);
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
      if (x < W)
        P::decode(pass, state[(S + y) * stride + x], a.out,
                  plane + (size_t)(y0 + y) * W + x);
    }
  }
}

// The device-memory route's kernel body for step k of a grid of
// (ceil(W / 32), ceil(H / kDeviceBlockRows), planes) blocks, a warp per 32
// columns of every kDeviceWarps-th row of the block's rows: k = -1 encodes
// the masks into both buffers and raises the first flag, k = 0 ..
// max_iters - 1 runs iteration k (the separable 3x3 minimum: each lane's
// vertical minimum, then its neighbours' by shuffles, the row's outside
// neighbours loaded by the edge lanes), and k = max_iters decodes the last
// buffer.
template <class P>
__device__ __forceinline__ void device_step(const Args& a, int k) {
  constexpr uint32_t kBg = P::kBg;
  const int H = a.H, W = a.W, planes = a.planes;
  const int plane = blockIdx.z, pass = plane % P::kPasses;
  const size_t mask = (size_t)(plane / P::kPasses) * H * W;
  const int lane = threadIdx.x & 31, x = blockIdx.x * 32 + lane;
  const int y0 = blockIdx.y * kDeviceBlockRows + (threadIdx.x >> 5);
  const int y1 = min(H, (int)(blockIdx.y + 1) * kDeviceBlockRows);
  uint32_t* buf0 = a.words + (size_t)plane * H * W;
  uint32_t* buf1 = buf0 + (size_t)planes * H * W;
  int* const flags = a.flags + plane;  // slot i at flags[i * planes]
  const bool first = blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0;
  if (k < 0) {
    for (int y = y0; y < y1 && x < W; y += kDeviceWarps) {
      const size_t p = (size_t)y * W + x;
      buf0[p] = buf1[p] = a.masks[mask + p] ? P::encode(pass, y, x, W) : kBg;
    }
    if (first) {
      flags[0] = 1;
      flags[planes] = 0;
      flags[2 * planes] = 0;
    }
    return;
  }
  if (k == a.max_iters) {
    const uint32_t* last = k & 1 ? buf1 : buf0;
    for (int y = y0; y < y1 && x < W; y += kDeviceWarps) {
      const size_t p = (size_t)y * W + x;
      P::decode(pass, last[p], a.out, mask + p);
    }
    return;
  }
  // Slot k % 3 was written by step k - 1, slot (k + 1) % 3 is written now
  // and slot (k + 2) % 3, read by step k - 1, is cleared for step k + 1.
  if (first) flags[(k + 2) % 3 * planes] = 0;
  if (!flags[k % 3 * planes]) return;  // the fixed point: both buffers hold it
  const uint32_t* src = k & 1 ? buf1 : buf0;
  uint32_t* dst = k & 1 ? buf0 : buf1;
  bool changed = false;
  for (int y = y0; y < y1; y += kDeviceWarps) {  // the same rows in every lane
    // The vertical minimum of column c at row y, background outside the mask.
    auto column = [&](int c) {
      if (c < 0 || c >= W) return kBg;
      const uint32_t* at = src + (size_t)y * W + c;
      uint32_t v = *at;
      if (y > 0) v = P::min(v, at[-W]);
      if (y + 1 < H) v = P::min(v, at[W]);
      return v;
    };
    const uint32_t v = column(x);
    uint32_t left = __shfl_up_sync(0xffffffffu, v, 1);
    uint32_t right = __shfl_down_sync(0xffffffffu, v, 1);
    if (lane == 0) left = column(x - 1);
    if (lane == 31) right = column(x + 1);
    const size_t p = (size_t)y * W + x;
    const uint32_t w = x < W ? src[p] : kBg;
    if (w != kBg) {
      const uint32_t n = P::min(P::min(left, v), right);
      changed |= n != w;
      dst[p] = n;
    }
  }
  // One store per mask and pass, not one per block: stores from every SM to
  // one address queue at its L2 slice.
  int* const next = flags + (k + 1) % 3 * planes;
  if (__syncthreads_or(changed) && threadIdx.x == 0 && !*(volatile int*)next) *next = 1;
}

// Rows per CTA, iterations per exchange, threads and shared bytes of the
// cluster route.
struct Shape {
  int planes, H, W, chunks, rows, S, threads;
  size_t smem;
};

inline Shape shape_of(int planes, int H, int W) {
  Shape s;
  s.planes = planes;
  s.H = H;
  s.W = W;
  s.chunks = (W + 31) / 32;
  s.rows = (H + kCluster - 1) / kCluster;
  s.S = std::min(kItersPerSync, s.rows);
  s.threads = 32 * std::min(kMaxWarps, s.rows + 2 * (s.S - 1));
  s.smem = (size_t)(2 * (s.rows + 2 * s.S) + 4 * s.S) * s.chunks * 32 * 4;
  return s;
}

// Whether an H x W mask takes the cluster route.
template <class P>
bool fits_cluster(int H, int W) {
  const Shape s = shape_of(1, H, W);
  return s.chunks <= P::kMaxChunks && s.smem + kStaticSmem <= (size_t)kMaxSmem;
}

// Device-memory bytes the device-memory route needs (the words, then the
// flags); 0 for the cluster route.
template <class P>
size_t scratch_bytes(int B, int H, int W) {
  if (fits_cluster<P>(H, W)) return 0;
  const size_t planes = (size_t)B * P::kPasses;
  return (2 * planes * H * W + 3 * planes) * 4;
}

// Launches the propagation of B masks of H x W on `st`: K::kernel<NCH>() is
// the including file's cluster kernel, K::step() its device-memory step
// kernel, for policy K::Policy; `scratch` holds scratch_bytes() bytes.
template <class K, int NCH = 1>
cudaError_t launch_cluster(const Shape& s, const Args& a, cudaStream_t st) {
  if constexpr (NCH < K::Policy::kMaxChunks) {
    if (s.chunks > NCH) return launch_cluster<K, NCH + 1>(s, a, st);
  }
  auto kernel = K::template kernel<NCH>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)s.planes * kCluster);
  cfg.blockDim = dim3(s.threads);
  cfg.dynamicSmemBytes = s.smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <class K>
cudaError_t launch(const uint8_t* masks, int32_t* const out[4], void* scratch,
                   int B, int H, int W, int max_iters, cudaStream_t st) {
  using P = typename K::Policy;
  const int planes = B * P::kPasses;
  if (B <= 0 || H <= 0 || W <= 0 || planes > 65535) return cudaErrorInvalidValue;
  Args a = {};
  a.masks = masks;
  for (int f = 0; f < 4; ++f) a.out[f] = out[f];
  a.H = H;
  a.W = W;
  a.max_iters = std::max(0, max_iters);
  a.planes = planes;
  if (fits_cluster<P>(H, W)) {
    const Shape s = shape_of(planes, H, W);
    a.rows = s.rows;
    a.S = s.S;
    return launch_cluster<K>(s, a, st);
  }
  if (scratch == nullptr) return cudaErrorInvalidValue;
  a.words = static_cast<uint32_t*>(scratch);
  a.flags = reinterpret_cast<int*>(a.words + 2 * (size_t)planes * H * W);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((W + 31) / 32, (H + kDeviceBlockRows - 1) / kDeviceBlockRows, planes);
  cfg.blockDim = dim3(kDeviceThreads);
  cfg.stream = st;
  for (int k = -1; k <= a.max_iters; ++k) {
    cudaError_t err = cudaLaunchKernelEx(&cfg, K::step(), a, k);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace cluster_strips
