// Per-pixel bounding-box extents of each pixel's 8-connected component.
//
// Replaces the Pallas TPU kernel
// video_classification_tpu/ops/pallas_components.py `_ext_kernel` (entry
// point `component_extents_pallas`): masked min/max propagation of
// (min_row, max_row, min_col, max_col) over the 8-neighbourhood, Jacobi
// (every pixel reads the previous iteration), until nothing changes or
// max_iters (H + W) iterations ran. Background gets
// (INT32_MAX, -1, INT32_MAX, -1).
//
// Design. One block per mask, the propagation resident in shared memory:
// two Jacobi copies of the four extent fields. At 112x112 int32 that is
// 401 KB, more than the 227 KB a block can use, so the fields are stored as
// bytes with remapped sentinels: min fields hold the coordinate (background
// 255), max fields hold coordinate + 1 (background 0); 8 bytes per pixel,
// 100 KB at 112x112, which needs H, W <= 255. A pixel is background iff its
// min_row byte is 255. The changed flag is __syncthreads_or, which is also
// the barrier between iterations. Outputs are decoded to int32 with the
// exact sentinels.
//
// Bound. A mask's iterations are latency-bound on one SM (a few hundred
// shared-memory min/max per thread per iteration, tens of iterations); the
// device-memory traffic is the mask in and 16 bytes per pixel out. Many
// masks in flight fill the card.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
extents_kernel(const uint8_t* __restrict__ masks, int32_t* mnr_out,
               int32_t* mxr_out, int32_t* mnc_out, int32_t* mxc_out, int H,
               int W, int max_iters) {
  extern __shared__ uint8_t smem[];
  const int hw = H * W;
  // buf(s, f): copy s (0/1) of field f (0 min_row, 1 max_row+1, 2 min_col,
  // 3 max_col+1).
  auto buf = [&](int s, int f) { return smem + (size_t)(s * 4 + f) * hw; };
  const size_t off = (size_t)blockIdx.x * hw;
  const uint8_t* mask = masks + off;

  for (int p = threadIdx.x; p < hw; p += kThreads) {
    const int y = p / W, x = p - y * W;
    const bool fg = mask[p] != 0;
    const uint8_t vals[4] = {
        (uint8_t)(fg ? y : 255), (uint8_t)(fg ? y + 1 : 0),
        (uint8_t)(fg ? x : 255), (uint8_t)(fg ? x + 1 : 0)};
    for (int f = 0; f < 4; ++f) {
      buf(0, f)[p] = vals[f];
      buf(1, f)[p] = vals[f];
    }
  }
  __syncthreads();

  int cur = 0;
  for (int it = 0; it < max_iters; ++it) {
    const uint8_t* nr0 = buf(cur, 0);
    const uint8_t* xr0 = buf(cur, 1);
    const uint8_t* nc0 = buf(cur, 2);
    const uint8_t* xc0 = buf(cur, 3);
    int changed = 0;
    for (int p = threadIdx.x; p < hw; p += kThreads) {
      const uint8_t a = nr0[p];
      if (a == 255) continue;  // background: sentinels in both copies
      const int y = p / W, x = p - y * W;
      uint8_t nr = a, xr = xr0[p], nc = nc0[p], xc = xc0[p];
      for (int dy = -1; dy <= 1; ++dy) {
        const int yy = y + dy;
        if (yy < 0 || yy >= H) continue;
        for (int dx = -1; dx <= 1; ++dx) {
          const int xx = x + dx;
          if ((dy == 0 && dx == 0) || xx < 0 || xx >= W) continue;
          const int q = yy * W + xx;
          nr = nr0[q] < nr ? nr0[q] : nr;
          xr = xr0[q] > xr ? xr0[q] : xr;
          nc = nc0[q] < nc ? nc0[q] : nc;
          xc = xc0[q] > xc ? xc0[q] : xc;
        }
      }
      changed |= (nr != a) | (xr != xr0[p]) | (nc != nc0[p]) | (xc != xc0[p]);
      buf(cur ^ 1, 0)[p] = nr;
      buf(cur ^ 1, 1)[p] = xr;
      buf(cur ^ 1, 2)[p] = nc;
      buf(cur ^ 1, 3)[p] = xc;
    }
    changed = __syncthreads_or(changed);
    cur ^= 1;
    if (!changed) break;
  }

  for (int p = threadIdx.x; p < hw; p += kThreads) {
    const uint8_t nr = buf(cur, 0)[p], nc = buf(cur, 2)[p];
    mnr_out[off + p] = nr == 255 ? INT_MAX : (int32_t)nr;
    mxr_out[off + p] = (int32_t)buf(cur, 1)[p] - 1;
    mnc_out[off + p] = nc == 255 ? INT_MAX : (int32_t)nc;
    mxc_out[off + p] = (int32_t)buf(cur, 3)[p] - 1;
  }
}

}  // namespace

// Launches one block per mask on `stream`; masks are (B, H, W) bytes, 0 for
// background, and each output is (B, H, W) int32.
cudaError_t component_extents_launch(const uint8_t* masks, int32_t* mnr,
                                     int32_t* mxr, int32_t* mnc, int32_t* mxc,
                                     int B, int H, int W, int max_iters,
                                     cudaStream_t st) {
  if (B <= 0 || H <= 0 || W <= 0 || H > 255 || W > 255)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)8 * H * W;
  cudaError_t err = cudaFuncSetAttribute(
      extents_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  extents_kernel<<<B, kThreads, smem, st>>>(masks, mnr, mxr, mnc, mxc, H, W,
                                            max_iters);
  return cudaGetLastError();
}
