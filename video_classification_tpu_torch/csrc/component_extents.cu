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
// The propagation is cluster_strips.cuh's (its note gives the bound and the
// design); this file gives it the words. Every field is a minimum once a
// maximum m is stored as M - m:
// - Narrow, H, W <= 255: the four fields as bytes of one word, byte 0
//   min_row, byte 1 254 - max_row, byte 2 min_col, byte 3 254 - max_col, so
//   one __vminu4 updates them together. Background is 0xFFFFFFFF and never
//   wins a minimum (a foreground byte is at most 254).
// - Wide, any side up to kMaxSide = 65534: 16-bit fields, two passes of one
//   word each, pass 0 (min_row, 65534 - max_row) and pass 1 (min_col,
//   65534 - max_col), one __vminu2 per neighbour, background 0xFFFF in each
//   field. The four fields never interact (each is its own masked
//   propagation over the same graph, with the same cap), so two passes that
//   stop on their own give the one propagation's result. The two passes of
//   a mask run side by side, as two clusters of one launch. A word of two
//   16-bit fields keeps the narrow strips' 4 bytes a pixel: a 240x320 mask
//   fits a 4-CTA cluster's shared memory, where a 64-bit word of all four
//   fields would need 8 CTAs and fewer iterations per exchange.
// The outputs are decoded to int32 with the exact sentinels.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "cluster_strips.cuh"

namespace {

namespace cs = cluster_strips;

constexpr int kNarrowSide = 255;
constexpr int kMaxSide = 65534;

struct Narrow {
  static constexpr int kPasses = 1;
  static constexpr int kMaxChunks = (kNarrowSide + 31) / 32;
  static constexpr uint32_t kBg = 0xFFFFFFFFu;
  __device__ static uint32_t encode(int, int y, int x, int) {
    return (uint32_t)y | (uint32_t)(254 - y) << 8 | (uint32_t)x << 16 |
           (uint32_t)(254 - x) << 24;
  }
  __device__ static uint32_t min(uint32_t a, uint32_t b) { return __vminu4(a, b); }
  __device__ static void decode(int, uint32_t w, int32_t* const* out, size_t p) {
    const uint32_t b0 = w & 0xFF, b1 = (w >> 8) & 0xFF, b2 = (w >> 16) & 0xFF,
                   b3 = w >> 24;
    out[0][p] = b0 == 0xFF ? INT_MAX : (int32_t)b0;
    out[1][p] = b1 == 0xFF ? -1 : 254 - (int32_t)b1;
    out[2][p] = b2 == 0xFF ? INT_MAX : (int32_t)b2;
    out[3][p] = b3 == 0xFF ? -1 : 254 - (int32_t)b3;
  }
};

struct Wide {
  static constexpr int kPasses = 2;  // rows, then columns
  static constexpr int kMaxChunks = 10;  // 320 columns, the frame's width
  static constexpr uint32_t kBg = 0xFFFFFFFFu;
  __device__ static uint32_t encode(int pass, int y, int x, int) {
    const uint32_t v = pass ? x : y;
    return v | (uint32_t)(kMaxSide - v) << 16;
  }
  __device__ static uint32_t min(uint32_t a, uint32_t b) { return __vminu2(a, b); }
  __device__ static void decode(int pass, uint32_t w, int32_t* const* out, size_t p) {
    // Selects, not out[2 * pass]: an array indexed at run time is copied
    // to local memory, and with that stack frame a launch of the
    // device-memory route took ~80 µs on an H100, ~17 µs without.
    int32_t* const mn = pass ? out[2] : out[0];
    int32_t* const mx = pass ? out[3] : out[1];
    const uint32_t lo = w & 0xFFFF, hi = w >> 16;
    mn[p] = lo == 0xFFFF ? INT_MAX : (int32_t)lo;
    mx[p] = hi == 0xFFFF ? -1 : kMaxSide - (int32_t)hi;
  }
};

template <class P, int NCH>
__global__ void __launch_bounds__(cs::kThreads)
extents_cluster_kernel(cs::Args a) {
  cs::propagate<P, NCH>(a);
}

template <class P>
__global__ void __launch_bounds__(cs::kDeviceThreads)
extents_device_kernel(cs::Args a, int k) {
  cs::device_step<P>(a, k);
}

template <class P>
struct Kernels {
  using Policy = P;
  template <int NCH>
  static auto kernel() { return extents_cluster_kernel<P, NCH>; }
  static auto step() { return extents_device_kernel<P>; }
};

}  // namespace

// The route of an H x W mask: 0 narrow words on the cluster, 1 wide words
// on the cluster, 2 wide words in device memory.
int component_extents_route(int H, int W) {
  if (H <= kNarrowSide && W <= kNarrowSide) return 0;
  return cs::fits_cluster<Wide>(H, W) ? 1 : 2;
}

// Scratch bytes a launch of B masks of H x W needs (0 on the cluster).
int64_t component_extents_scratch_bytes(int B, int H, int W) {
  return component_extents_route(H, W) == 2 ? cs::scratch_bytes<Wide>(B, H, W) : 0;
}

// Launches the propagation of B masks on `st`; masks are (B, H, W) bytes, 0
// for background, each output is (B, H, W) int32, and `scratch` holds
// component_extents_scratch_bytes(B, H, W) bytes.
cudaError_t component_extents_launch(const uint8_t* masks, int32_t* mnr,
                                     int32_t* mxr, int32_t* mnc, int32_t* mxc,
                                     void* scratch, int B, int H, int W,
                                     int max_iters, cudaStream_t st) {
  if (H > kMaxSide || W > kMaxSide) return cudaErrorInvalidValue;
  int32_t* const out[4] = {mnr, mxr, mnc, mxc};
  if (component_extents_route(H, W) == 0)
    return cs::launch<Kernels<Narrow>>(masks, out, scratch, B, H, W, max_iters, st);
  return cs::launch<Kernels<Wide>>(masks, out, scratch, B, H, W, max_iters, st);
}
