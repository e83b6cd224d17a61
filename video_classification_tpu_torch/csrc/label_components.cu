// Connected-component labels (8-connectivity) of a batch of masks.
//
// Replaces the Pallas TPU kernel
// video_classification_tpu/ops/pallas_components.py `_cc_kernel` (entry point
// `label_components_pallas`) and the XLA loop of ops/components.py
// `label_components`: every foreground pixel starts with its row-major index
// r * W + c, background with INT32_MAX; each round every foreground pixel
// takes the minimum over itself and its 8 neighbours of the previous round's
// labels (Jacobi), until a round changes nothing or max_iters rounds ran.
// Stopping at the fixed point gives the Pallas kernel's result, which runs
// all H + W rounds. The rounds must be Jacobi: an in-place (Gauss-Seidel)
// propagation reaches the same fixed point but gives other labels when
// max_iters cuts it short.
//
// The propagation is cluster_strips.cuh's (its note gives the bound and the
// design): a label is one 32-bit word, background INT32_MAX, which no label
// (at most H W - 1 < INT32_MAX) reaches, so the masked 3x3 minimum is
// separable as it is for the extents. At 4 bytes a pixel a 240x320 mask's
// strips fit a 4-CTA cluster's shared memory; larger masks take the
// device-memory route.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "cluster_strips.cuh"

namespace {

namespace cs = cluster_strips;

struct Labels {
  static constexpr int kPasses = 1;
  static constexpr int kMaxChunks = 10;  // 320 columns, the frame's width
  static constexpr uint32_t kBg = INT_MAX;
  __device__ static uint32_t encode(int, int y, int x, int W) {
    return (uint32_t)(y * W + x);
  }
  __device__ static uint32_t min(uint32_t a, uint32_t b) { return ::min(a, b); }
  __device__ static void decode(int, uint32_t w, int32_t* const* out, size_t p) {
    out[0][p] = (int32_t)w;
  }
};

template <int NCH>
__global__ void __launch_bounds__(cs::kThreads)
labels_cluster_kernel(cs::Args a) {
  cs::propagate<Labels, NCH>(a);
}

__global__ void __launch_bounds__(cs::kDeviceThreads)
labels_device_kernel(cs::Args a, int k) {
  cs::device_step<Labels>(a, k);
}

struct Kernels {
  using Policy = Labels;
  template <int NCH>
  static auto kernel() { return labels_cluster_kernel<NCH>; }
  static auto step() { return labels_device_kernel; }
};

}  // namespace

// The route of an H x W mask: 0 on the cluster, 1 in device memory.
int label_components_route(int H, int W) {
  return cs::fits_cluster<Labels>(H, W) ? 0 : 1;
}

// Scratch bytes a launch of B masks of H x W needs (0 on the cluster).
int64_t label_components_scratch_bytes(int B, int H, int W) {
  return cs::scratch_bytes<Labels>(B, H, W);
}

// Launches the labelling of B masks on `st`. masks: (B, H, W) bytes, 0 for
// background; out: (B, H, W) int32; `scratch` holds
// label_components_scratch_bytes(B, H, W) bytes.
cudaError_t label_components_launch(const uint8_t* masks, int32_t* out,
                                    void* scratch, int B, int H, int W,
                                    int max_iters, cudaStream_t st) {
  int32_t* const outs[4] = {out, nullptr, nullptr, nullptr};
  return cs::launch<Kernels>(masks, outs, scratch, B, H, W, max_iters, st);
}
