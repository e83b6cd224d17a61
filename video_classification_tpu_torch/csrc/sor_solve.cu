// The per-op flow level's SOR solve, for all frame pairs of a batch at once.
//
// Replaces the Pallas TPU kernel video_classification_tpu/ops/pallas_flow.py
// `_sor_kernel` (entry point `sor_solve_pallas`). Same semantics: from the
// per-pixel normal equations (a11, a12, a22, b1, b2) and the half-point
// smoothness weights (wu, wd, wl, wr) on the total flow (u + du, v + dv),
// hoist wsum = wu + wd + wl + wr, the reciprocal diagonals
// 1 / (a + alpha * wsum) and the constant smoothness term
// neighbour(u) - wsum * u (zero outside the frame); then n_sor red-black
// sweeps from the warm start (du0, dv0), red ((y + x) % 2 == 0) first, each
// half-sweep updating du on its colour and then dv with the new du. The
// Pallas kernel's n_sor // 2 double trips plus a remainder are the same
// sequence of half-sweeps.
//
// Design. The TPU kernel keeps one pair's 13 fields in VMEM (~4 MB at
// 240x320); one 240x320 f32 field (300 KB) already exceeds the 227 KB of
// shared memory of one H100 block. So, as in flow_level.cu, a solve is a
// host-side launch sequence over all pairs: one setup kernel writes the
// hoisted fields to scratch and the warm start to (du, dv), then 2 * n_sor
// half-sweep launches. A half-sweep thread updates one pixel of its colour in
// place, reading only the other colour's neighbours, so the in-place update
// is exactly the twin's Jacobi update of that colour.
//
// Bound. Each half-sweep streams ~15 fields of the half of the pixels it
// updates through device memory (a 101-pair 240x320 solve holds ~470 MB of
// fields, far above the 50 MB L2), so the solve is bound by that traffic,
// not by its ~32 f32 operations per pixel per sweep; fusing sweeps in
// shared-memory tiles is the next step.
//
// Built with -fmad=false: every product and sum is rounded as in the plain
// PyTorch twin (ops/sor_solve.py::sor_solve_reference), in the same order.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Solve {
  const float *a11, *a12, *a22, *b1, *b2, *wu, *wd, *wl, *wr, *u, *v;
  const float *du0, *dv0;
  float *inv_u, *inv_v, *nuc, *nvc;  // scratch, (B, H, W) each
  float *du, *dv;                    // outputs, (B, H, W)
  int B, H, W;
  float alpha, omega, one_m_omega;
};

// Hoisted fields and the warm start.
__global__ void __launch_bounds__(kThreads) sor_solve_setup_kernel(Solve S) {
  const int b = blockIdx.y, H = S.H, W = S.W, hw = H * W;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= hw) return;
  const int y = p / W, x = p - y * W;
  const size_t base = (size_t)b * hw, i = base + p;
  const float wu = S.wu[i], wd = S.wd[i], wl = S.wl[i], wr = S.wr[i];
  const float wsum = wu + wd + wl + wr;
  const float* u = S.u + base;
  const float* v = S.v + base;
  const float u_up = y > 0 ? u[p - W] : 0.f, u_dn = y < H - 1 ? u[p + W] : 0.f;
  const float u_lf = x > 0 ? u[p - 1] : 0.f, u_rt = x < W - 1 ? u[p + 1] : 0.f;
  const float v_up = y > 0 ? v[p - W] : 0.f, v_dn = y < H - 1 ? v[p + W] : 0.f;
  const float v_lf = x > 0 ? v[p - 1] : 0.f, v_rt = x < W - 1 ? v[p + 1] : 0.f;
  const float nu = wu * u_up + wd * u_dn + wl * u_lf + wr * u_rt;
  const float nv = wu * v_up + wd * v_dn + wl * v_lf + wr * v_rt;
  S.inv_u[i] = 1.f / (S.a11[i] + S.alpha * wsum);
  S.inv_v[i] = 1.f / (S.a22[i] + S.alpha * wsum);
  S.nuc[i] = nu - wsum * u[p];
  S.nvc[i] = nv - wsum * v[p];
  S.du[i] = S.du0[i];
  S.dv[i] = S.dv0[i];
}

// One half-sweep: the pixels with (y + x) % 2 == colour.
__global__ void __launch_bounds__(kThreads)
sor_solve_half_kernel(Solve S, int colour) {
  const int b = blockIdx.y, H = S.H, W = S.W;
  const int half = (W + 1) / 2;
  const int s = blockIdx.x * kThreads + threadIdx.x;
  const int y = s / half;
  const int x = 2 * (s - y * half) + ((y + colour) & 1);
  if (y >= H || x >= W) return;
  const int p = y * W + x;
  const size_t base = (size_t)b * H * W, i = base + p;
  float* du = S.du + base;
  float* dv = S.dv + base;
  const float wu = S.wu[i], wd = S.wd[i], wl = S.wl[i], wr = S.wr[i];
  const float a12 = S.a12[i];

  const float du_c = du[p], dv_c = dv[p];
  const float du_up = y > 0 ? du[p - W] : 0.f, du_dn = y < H - 1 ? du[p + W] : 0.f;
  const float du_lf = x > 0 ? du[p - 1] : 0.f, du_rt = x < W - 1 ? du[p + 1] : 0.f;
  const float su = S.nuc[i] + (wu * du_up + wd * du_dn + wl * du_lf + wr * du_rt);
  const float new_du = (S.b1[i] - a12 * dv_c + S.alpha * su) * S.inv_u[i];
  const float du_n = S.one_m_omega * du_c + S.omega * new_du;

  const float dv_up = y > 0 ? dv[p - W] : 0.f, dv_dn = y < H - 1 ? dv[p + W] : 0.f;
  const float dv_lf = x > 0 ? dv[p - 1] : 0.f, dv_rt = x < W - 1 ? dv[p + 1] : 0.f;
  const float sv = S.nvc[i] + (wu * dv_up + wd * dv_dn + wl * dv_lf + wr * dv_rt);
  const float new_dv = (S.b2[i] - a12 * du_n + S.alpha * sv) * S.inv_v[i];
  du[p] = du_n;
  dv[p] = S.one_m_omega * dv_c + S.omega * new_dv;
}

}  // namespace

// Launches the solve on `stream`. fields: the 13 inputs (a11, a12, a22, b1,
// b2, wu, wd, wl, wr, u, v, du0, dv0), each (B, H, W) contiguous float32;
// scratch: 4 x (B, H, W) floats; du, dv: the (B, H, W) outputs.
cudaError_t sor_solve_launch(const float* const* fields, float* scratch,
                             float* du, float* dv, int B, int H, int W,
                             int n_sor, float alpha, float omega,
                             float one_m_omega, cudaStream_t st) {
  if (B <= 0 || H <= 0 || W <= 0 || n_sor < 0) return cudaErrorInvalidValue;
  const size_t n = (size_t)B * H * W;
  const Solve S{fields[0], fields[1], fields[2], fields[3], fields[4],
                fields[5], fields[6], fields[7], fields[8], fields[9],
                fields[10], fields[11], fields[12],
                scratch, scratch + n, scratch + 2 * n, scratch + 3 * n,
                du, dv, B, H, W, alpha, omega, one_m_omega};
  const dim3 px_grid((H * W + kThreads - 1) / kThreads, B);
  const dim3 sor_grid((H * ((W + 1) / 2) + kThreads - 1) / kThreads, B);
  sor_solve_setup_kernel<<<px_grid, kThreads, 0, st>>>(S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  for (int s = 0; s < n_sor; ++s) {
    sor_solve_half_kernel<<<sor_grid, kThreads, 0, st>>>(S, 0);
    sor_solve_half_kernel<<<sor_grid, kThreads, 0, st>>>(S, 1);
  }
  return cudaGetLastError();
}
