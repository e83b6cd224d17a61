// Bilinear warp of a batch of channels-last images by dense flows.
//
// Replaces the Pallas TPU kernel video_classification_tpu/ops/pallas_flow.py
// `_warp_kernel` / `_warp_kernel_loop` (entry point
// `warp_select_shift_pallas`) and the radius cascade with its gather fallback
// around it (ops/flow.py `_warp`). Same function as ops/flow.py
// `_warp_bilinear`: sample im at (x + u, y + v), the coordinates clipped to
// [0, h-1] x [0, w-1], the base corner clamped to (h-2, w-2), and the blend
// v00*(1-wy)*(1-wx) + v01*(1-wy)*wx + v10*wy*(1-wx) + v11*wy*wx, left to
// right.
//
// Design. The select-shift form, its (8, 128) tile padding and transposes
// exist on the TPU only because a TPU gather is slow, and they are exact only
// within a radius, hence the cascade. On Hopper the function is one gather:
// one thread per output pixel computes y0, x0, wy, wx as the twin does and
// reads the four corners of all C channels from the channels-last image. One
// exact kernel serves every flow at every level, with no radius tiers.
//
// Bound. Device memory: each pixel reads its flow (8 bytes) and 4 x C
// floats, writes C floats; neighbouring threads read neighbouring corners, so
// the image is read about once from DRAM (a 101-pair 240x320x3 batch is
// ~250 MB in and out, ~0.075 ms at 3.35 TB/s). ~20 f32 operations per pixel
// are far below the operation bound.
//
// Built with -fmad=false: every product and sum is rounded as in the plain
// PyTorch twin (ops/warp.py::warp_bilinear_reference), in the same order.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
warp_bilinear_kernel(const float* __restrict__ im, const float* __restrict__ u,
                     const float* __restrict__ v, float* __restrict__ out,
                     int B, int H, int W, int C) {
  const int hw = H * W;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (p >= hw) return;
  const int y = p / W, x = p - y * W;
  const size_t i = (size_t)b * hw + p;

  const float ys = fminf(fmaxf((float)y + v[i], 0.f), (float)(H - 1));
  const float xs = fminf(fmaxf((float)x + u[i], 0.f), (float)(W - 1));
  const int y0 = min((int)floorf(ys), H - 2);
  const int x0 = min((int)floorf(xs), W - 2);
  const float wy = ys - (float)y0, wx = xs - (float)x0;
  const float omy = 1.f - wy, omx = 1.f - wx;

  const float* img = im + (size_t)b * hw * C;
  const size_t c00 = ((size_t)y0 * W + x0) * C;
  const size_t c10 = c00 + (size_t)W * C;
  float* o = out + i * C;
  for (int c = 0; c < C; ++c) {
    float acc = img[c00 + c] * omy * omx;
    acc = acc + img[c00 + C + c] * omy * wx;
    acc = acc + img[c10 + c] * wy * omx;
    acc = acc + img[c10 + C + c] * wy * wx;
    o[c] = acc;
  }
}

}  // namespace

// Launches the warp on `stream`: im (B, H, W, C), u, v (B, H, W), out like
// im, all contiguous float32.
cudaError_t warp_bilinear_launch(const float* im, const float* u,
                                 const float* v, float* out, int B, int H,
                                 int W, int C, cudaStream_t st) {
  if (B <= 0 || H < 2 || W < 2 || C <= 0) return cudaErrorInvalidValue;
  const dim3 grid((H * W + kThreads - 1) / kThreads, B);
  warp_bilinear_kernel<<<grid, kThreads, 0, st>>>(im, u, v, out, B, H, W, C);
  return cudaGetLastError();
}
