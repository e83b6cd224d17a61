// The IRLS coefficients of one inner of the per-op flow level, for all frame
// pairs of a batch at once.
//
// Replaces no Pallas kernel: on the TPU this is XLA's fusion of the JAX
// package's per-op level, video_classification_tpu/ops/flow.py
// `_flow_level` (the gradients and `it` of an outer, then per inner the
// robust data weight psi, the five channel sums, the smoothness weight phi of
// the total flow and its edge weights). Same function as the plain twin
// ops/irls.py::irls_coefficients_reference, from im1, the warped im2 and the
// warp its gradients take (warped_grad: warped itself with one inner,
// K5's other order of its first fused multiply-add with several), the flow
// (u, v) and the increments (du, dv):
//   ix = 0.5*(ix1 + ix2), iy likewise: the edge-replicated central
//        differences 0.5*(next - prev) of im1 and of warped_grad;
//   it = warped - im1;
//   rho = fma(iy, dv, fma(ix, du, it)), psi = rsqrt(fma(rho, rho, eps));
//   a11, a12, a22, -b1, -b2: from 0, each channel's (psi*x)*y fused into the
//        running sum, in channel order;
//   phi = rsqrt(fma(vy, vy, fma(vx, vx, fma(ux, ux, uy*uy))) + eps), the
//        gradients of (u + du) and (v + dv), each sum rounded first;
//   wu, wd, wl, wr = 0.5*(phi + phi_neighbour), zero across the border.
// The nine fields feed K4 (sor_solve.cu) as they are.
//
// Design. One thread per pixel, a loop over the channels. phi is recomputed
// at the four neighbours instead of being written by a first launch and read
// by a second: a function of the position alone, it is the same value either
// way, and the neighbours' (u, du, v, dv) come from L1. K1's coeff_kernel
// computes the same quantities in another order (merged gradients, one
// inner), so nothing is shared with flow_level.cu.
//
// Bound. Device memory: a pixel reads im1, warped and warped_grad (3 x C
// floats; 2 x C when warped_grad is warped) and u, v, du, dv, and writes nine
// floats: 76 bytes at C = 3 with one inner, 88 with two. The function needs
// ~32 + 25 C f32 operations and 1 + C reciprocal square roots per pixel
// (~105 + 5 C as computed here, phi five times), far below the operation
// bound.
//
// Built with -fmad=false, so nvcc contracts nothing on its own: the fused
// multiply-adds are the __fmaf_rn of the twin's fma_f32 (XLA:CPU's
// contractions of the JAX package's level), psi and phi the correctly rounded
// __frsqrt_rn of its rsqrt_f32, and every other product and sum is rounded as
// there, in the same order.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Irls {
  const float* __restrict__ im1;          // (B, H, W, C)
  const float* __restrict__ warped;       // (B, H, W, C)
  const float* __restrict__ warped_grad;  // (B, H, W, C), may be warped
  const float* __restrict__ u;            // (B, H, W)
  const float* __restrict__ v;
  const float* __restrict__ du;
  const float* __restrict__ dv;
  float* __restrict__ out;                // 9 x (B, H, W)
  int B, H, W, C;
  float eps;
};

// The edge-replicated central difference of f at the neighbours (next, prev).
__device__ __forceinline__ float half_diff(float next, float prev) {
  return 0.5f * (next - prev);
}

// f + df at offset q of one pair's (H, W) fields.
__device__ __forceinline__ float total(const float* f, const float* df,
                                       size_t q) {
  return f[q] + df[q];
}

// The Charbonnier smoothness weight phi of the total flow at (y, x) of the
// pair whose fields start at `base`.
__device__ float phi_at(const Irls& L, size_t base, int y, int x) {
  const int W = L.W;
  const int xp = x < W - 1 ? x + 1 : x, xm = x > 0 ? x - 1 : x;
  const int yp = y < L.H - 1 ? y + 1 : y, ym = y > 0 ? y - 1 : y;
  const float* u = L.u + base;
  const float* du = L.du + base;
  const float* v = L.v + base;
  const float* dv = L.dv + base;
  const size_t r = (size_t)y * W, rp = (size_t)yp * W, rm = (size_t)ym * W;
  const float ux = half_diff(total(u, du, r + xp), total(u, du, r + xm));
  const float uy = half_diff(total(u, du, rp + x), total(u, du, rm + x));
  const float vx = half_diff(total(v, dv, r + xp), total(v, dv, r + xm));
  const float vy = half_diff(total(v, dv, rp + x), total(v, dv, rm + x));
  const float mag =
      __fmaf_rn(vy, vy, __fmaf_rn(vx, vx, __fmaf_rn(ux, ux, uy * uy)));
  return __frsqrt_rn(mag + L.eps);
}

__global__ void __launch_bounds__(kThreads) irls_kernel(Irls L) {
  const int b = blockIdx.y, hw = L.H * L.W, H = L.H, W = L.W, C = L.C;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= hw) return;
  const int y = p / W, x = p - y * W;
  const size_t base = (size_t)b * hw;
  const size_t i = base + p;
  const float du = L.du[i], dv = L.dv[i];

  const int xp = x < W - 1 ? x + 1 : x, xm = x > 0 ? x - 1 : x;
  const int yp = y < H - 1 ? y + 1 : y, ym = y > 0 ? y - 1 : y;
  const size_t qc = (size_t)p * C;
  const size_t qxp = ((size_t)y * W + xp) * C, qxm = ((size_t)y * W + xm) * C;
  const size_t qyp = ((size_t)yp * W + x) * C, qym = ((size_t)ym * W + x) * C;
  const float* im1 = L.im1 + base * C;
  const float* wp = L.warped + base * C;
  const float* wg = L.warped_grad + base * C;

  float a11 = 0.f, a12 = 0.f, a22 = 0.f, nb1 = 0.f, nb2 = 0.f;
  for (int c = 0; c < C; ++c) {
    const float ix1 = half_diff(im1[qxp + c], im1[qxm + c]);
    const float iy1 = half_diff(im1[qyp + c], im1[qym + c]);
    const float ix2 = half_diff(wg[qxp + c], wg[qxm + c]);
    const float iy2 = half_diff(wg[qyp + c], wg[qym + c]);
    const float ix = 0.5f * (ix1 + ix2), iy = 0.5f * (iy1 + iy2);
    const float it = wp[qc + c] - im1[qc + c];
    const float rho = __fmaf_rn(iy, dv, __fmaf_rn(ix, du, it));
    const float psi = __frsqrt_rn(__fmaf_rn(rho, rho, L.eps));
    const float px = psi * ix, py = psi * iy;
    a11 = __fmaf_rn(px, ix, a11);
    a12 = __fmaf_rn(px, iy, a12);
    a22 = __fmaf_rn(py, iy, a22);
    nb1 = __fmaf_rn(px, it, nb1);
    nb2 = __fmaf_rn(py, it, nb2);
  }

  const float ph = phi_at(L, base, y, x);
  const float wu = y == 0 ? 0.f : 0.5f * (ph + phi_at(L, base, y - 1, x));
  const float wd = y == H - 1 ? 0.f : 0.5f * (ph + phi_at(L, base, y + 1, x));
  const float wl = x == 0 ? 0.f : 0.5f * (ph + phi_at(L, base, y, x - 1));
  const float wr = x == W - 1 ? 0.f : 0.5f * (ph + phi_at(L, base, y, x + 1));

  const size_t n = (size_t)L.B * hw;
  float* o = L.out + i;
  o[0] = a11;
  o[n] = a12;
  o[2 * n] = a22;
  o[3 * n] = -nb1;
  o[4 * n] = -nb2;
  o[5 * n] = wu;
  o[6 * n] = wd;
  o[7 * n] = wl;
  o[8 * n] = wr;
}

}  // namespace

// Launches the coefficients on `stream`: im1, warped, warped_grad
// (B, H, W, C), u, v, du, dv (B, H, W), all contiguous float32 (warped_grad
// may be warped); out 9 x (B, H, W) float32 takes a11, a12, a22, b1, b2, wu,
// wd, wl, wr.
cudaError_t irls_coefficients_launch(const float* im1, const float* warped,
                                     const float* warped_grad, const float* u,
                                     const float* v, const float* du,
                                     const float* dv, float* out, int B, int H,
                                     int W, int C, float eps,
                                     cudaStream_t st) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C <= 0)
    return cudaErrorInvalidValue;
  const Irls L{im1, warped, warped_grad, u, v, du, dv, out, B, H, W, C, eps};
  const dim3 grid((H * W + kThreads - 1) / kThreads, B);
  irls_kernel<<<grid, kThreads, 0, st>>>(L);
  return cudaGetLastError();
}
