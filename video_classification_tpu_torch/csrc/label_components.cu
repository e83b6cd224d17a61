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
// Design. One block per mask, two label buffers (the previous and the next
// round), and a block-wide change flag by __syncthreads_or, which is also the
// barrier between rounds. When both buffers fit a block's shared memory
// (2 x 4 bytes per pixel, up to 29,056 pixels: 112x112 takes 100 KB) they
// live there; larger masks (240x320) use two buffers per mask in device
// memory scratch, which the same block-wide rounds read through L1/L2 (a
// barrier makes one thread's global writes visible to its block).
//
// Bound. A mask's rounds are latency-bound on one SM: per round a thread
// reads 9 labels per pixel it owns, and a round cannot start before the
// previous one ends. Device-memory traffic is the mask in (1 byte per pixel)
// and the labels out (4 bytes); many masks in flight fill the card.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
label_components_kernel(const uint8_t* __restrict__ masks,
                        int32_t* __restrict__ out, int32_t* scratch, int H,
                        int W, int max_iters, int in_smem) {
  extern __shared__ int32_t smem[];
  const int hw = H * W;
  const size_t off = (size_t)blockIdx.x * hw;
  int32_t* cur = in_smem ? smem : scratch + 2 * off;
  int32_t* nxt = cur + hw;
  const uint8_t* mask = masks + off;

  for (int p = threadIdx.x; p < hw; p += kThreads) {
    const int32_t l = mask[p] != 0 ? p : INT_MAX;
    cur[p] = l;
    nxt[p] = l;  // background keeps INT_MAX in both buffers
  }
  __syncthreads();

  for (int it = 0; it < max_iters; ++it) {
    int changed = 0;
    for (int p = threadIdx.x; p < hw; p += kThreads) {
      const int32_t old = cur[p];
      if (old == INT_MAX) continue;  // background
      const int y = p / W, x = p - y * W;
      int32_t m = old;
      for (int dy = -1; dy <= 1; ++dy) {
        const int yy = y + dy;
        if (yy < 0 || yy >= H) continue;
        for (int dx = -1; dx <= 1; ++dx) {
          const int xx = x + dx;
          if (xx < 0 || xx >= W) continue;
          m = min(m, cur[yy * W + xx]);
        }
      }
      changed |= m != old;
      nxt[p] = m;
    }
    changed = __syncthreads_or(changed);
    int32_t* t = cur;
    cur = nxt;
    nxt = t;
    if (!changed) break;
  }

  for (int p = threadIdx.x; p < hw; p += kThreads) out[off + p] = cur[p];
}

}  // namespace

// Bytes of shared memory one mask needs for both buffers.
int64_t label_components_smem_bytes(int64_t H, int64_t W) {
  return 2 * 4 * H * W;
}

// Launches one block per mask on `stream`. masks: (B, H, W) bytes, 0 for
// background; out: (B, H, W) int32; scratch: 2 x (B, H, W) int32, used (and
// required) only when the buffers exceed max_smem bytes of shared memory.
cudaError_t label_components_launch(const uint8_t* masks, int32_t* out,
                                    int32_t* scratch, int B, int H, int W,
                                    int max_iters, int64_t max_smem,
                                    cudaStream_t st) {
  if (B <= 0 || H <= 0 || W <= 0) return cudaErrorInvalidValue;
  const int64_t smem = label_components_smem_bytes(H, W);
  const int in_smem = smem <= max_smem;
  if (!in_smem && scratch == nullptr) return cudaErrorInvalidValue;
  if (in_smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        label_components_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  label_components_kernel<<<B, kThreads, in_smem ? smem : 0, st>>>(
      masks, out, scratch, H, W, max_iters, in_smem);
  return cudaGetLastError();
}
