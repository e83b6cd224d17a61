// One pyramid level of the variational optical-flow solver, for all frame
// pairs of a batch at once.
//
// Replaces the Pallas TPU kernel video_classification_tpu/ops/pallas_flow.py
// `_flow_level_kernel` (entry point `flow_level_fused_pallas`). Same
// semantics: n_outer fixed-point relinearisations, each a bilinear warp of
// im2 by (u, v) with offsets clamped to +-r, r = clip(ceil(max|flow|), 1,
// r_cap) taken per pair from that outer's pre-clamp max, and the base corner
// clamped to (h-2, w-2); IRLS data terms from the gradient of
// 0.5*(im1 + warped) with psi = 1/sqrt(it^2 + eps); Charbonnier half-point
// edge weights, zero across the border; n_sor red-black SOR sweeps on
// (du, dv) from zero, with the reciprocal diagonals and the constant
// total-flow smoothness term hoisted out of the sweeps. A pair stops once an
// outer's max|du, dv| <= outer_tol; mx returns the per-pair max over the
// executed outers of the pre-clamp max|flow|.
//
// Design. The TPU kernel keeps a whole level resident in VMEM for all outers
// and sweeps; one 240x320 f32 field (300 KB) already exceeds the 227 KB of
// shared memory of one H100 block, so here the level is a host-side sequence
// of kernels over all B pairs: per outer one warp+phi kernel, one
// coefficient kernel, the SOR half-sweeps in on-chip tiles (sor_tiles.cuh,
// shared with sor_solve.cu: 12 half-sweeps per launch on 64x64 windows, the
// read-only fields in registers, (du, dv) in shared memory and ping-pong
// buffers in device memory; all half-sweeps in one launch for a frame of at
// most 64x64), and one finish kernel that adds the increments and reduces
// max|du,dv| and max|flow| per pair with atomics. Converged pairs are
// switched off by per-pair flags that every kernel reads from device memory,
// so a level never syncs the host.
//
// Bound. The kernel's bound is its ~1e3 f32 operations per pixel per outer
// (inputs and outputs are a few fields). What it moves is the SOR state:
// each tiled launch loads 13 fields over 2.56x the frame once per 12
// half-sweeps at 240x320 (before: 15 fields per half-sweep), and the
// half-sweeps read 12 shared-memory words per updated pixel.
//
// Built with -fmad=false: every product and sum is rounded as in the plain
// PyTorch twin (ops/flow_level.py::flow_level_reference), in the same order.

#include <cuda_runtime.h>

#include "sor_tiles.cuh"

namespace {

constexpr int kThreads = 256;

// A12 .. NVC in sor_tiles::Field's order; (DU, DV) and (DU2, DV2) are the
// SOR's ping-pong buffers.
enum Field { A12, B1, B2, WU, WD, WL, WR, INVU, INVV, NUC, NVC, DU, DV, DU2,
             DV2, PHI, kNumFields };

struct Level {
  const float* im1;   // (B, H, W, C)
  const float* im2;   // (B, H, W, C)
  float* u;           // (B, H, W), updated in place
  float* v;           // (B, H, W), updated in place
  float* mx;          // (B,), zero on entry
  float* fields;      // kNumFields x (B, H, W) scratch
  float* warped;      // (B, H, W, C) scratch
  float* red;         // (2 n_outer + 1) x B, zero on entry:
                      //   maxflow[k] at k*B, delta[k] at (n_outer+1+k)*B
  int B, H, W, C, n_outer, r_cap;
  float alpha, omega, one_m_omega, eps, outer_tol;
};

__device__ __forceinline__ float* field(const Level& L, int f) {
  return L.fields + (size_t)f * L.B * L.H * L.W;
}

__device__ __forceinline__ float* maxflow(const Level& L, int k) {
  return L.red + (size_t)k * L.B;
}

__device__ __forceinline__ float* delta(const Level& L, int k) {
  return L.red + (size_t)(L.n_outer + 1 + k) * L.B;
}

// A pair runs outer k iff every earlier outer moved it by more than the tol.
__device__ __forceinline__ bool active(const Level& L, int k, int b) {
  for (int j = 0; j < k; ++j)
    if (!(delta(L, j)[b] > L.outer_tol)) return false;
  return true;
}

// Max of non-negative floats: their bit patterns order like the values.
__device__ __forceinline__ void atomic_max_nonneg(float* addr, float x) {
  atomicMax(reinterpret_cast<int*>(addr), __float_as_int(x));
}

// Block-wide max; every thread of the block must call it. Valid in thread 0.
__device__ float block_max(float x) {
  __shared__ float partial[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // partial may still be read by a previous call
  if (lane == 0) partial[warp] = x;
  __syncthreads();
  x = (lane < kThreads / 32) ? partial[lane] : 0.f;
  if (warp == 0)
    for (int o = 16; o > 0; o >>= 1)
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__global__ void __launch_bounds__(kThreads) maxflow_init_kernel(Level L) {
  const int b = blockIdx.y, hw = L.H * L.W;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  float m = 0.f;
  if (p < hw) {
    const size_t i = (size_t)b * hw + p;
    m = fmaxf(fabsf(L.u[i]), fabsf(L.v[i]));
  }
  m = block_max(m);
  if (threadIdx.x == 0) atomic_max_nonneg(maxflow(L, 0) + b, m);
}

// Warp of im2 by the clamped flow, and the smoothness weight phi.
__global__ void __launch_bounds__(kThreads) warp_phi_kernel(Level L, int k) {
  const int b = blockIdx.y, hw = L.H * L.W, H = L.H, W = L.W, C = L.C;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= hw || !active(L, k, b)) return;
  const int y = p / W, x = p - y * W;
  const size_t base = (size_t)b * hw;
  const size_t i = base + p;
  const float* u = L.u + base;
  const float* v = L.v + base;

  const float rc = fminf(ceilf(maxflow(L, k)[b]), (float)L.r_cap);
  const float r = (float)max((int)rc, 1);
  const float ys = fminf(fmaxf((float)y + fminf(fmaxf(v[p], -r), r), 0.f),
                         (float)(H - 1));
  const float xs = fminf(fmaxf((float)x + fminf(fmaxf(u[p], -r), r), 0.f),
                         (float)(W - 1));
  const int y0 = min((int)floorf(ys), H - 2);
  const int x0 = min((int)floorf(xs), W - 2);
  const float wy = ys - (float)y0, wx = xs - (float)x0;
  const float omy = 1.f - wy, omx = 1.f - wx;
  const float w00 = omy * omx, w01 = omy * wx, w10 = wy * omx, w11 = wy * wx;
  const float* im2 = L.im2 + base * C;
  const size_t c00 = ((size_t)y0 * W + x0) * C;
  const size_t c10 = c00 + (size_t)W * C;
  for (int c = 0; c < C; ++c) {
    float acc = im2[c00 + c] * w00;
    acc = acc + im2[c00 + C + c] * w01;
    acc = acc + im2[c10 + c] * w10;
    acc = acc + im2[c10 + C + c] * w11;
    L.warped[i * C + c] = acc;
  }

  const int xp = x < W - 1 ? x + 1 : x, xm = x > 0 ? x - 1 : x;
  const int yp = y < H - 1 ? y + 1 : y, ym = y > 0 ? y - 1 : y;
  const float ux = 0.5f * (u[y * W + xp] - u[y * W + xm]);
  const float uy = 0.5f * (u[yp * W + x] - u[ym * W + x]);
  const float vx = 0.5f * (v[y * W + xp] - v[y * W + xm]);
  const float vy = 0.5f * (v[yp * W + x] - v[ym * W + x]);
  const float mag = ux * ux + uy * uy + vx * vx + vy * vy;
  field(L, PHI)[i] = 1.f / sqrtf(mag + L.eps);
}

// IRLS data terms, edge weights, hoisted reciprocals and constant terms, and
// the SOR's zero start in the field pair (zero, zero + 1).
__global__ void __launch_bounds__(kThreads) coeff_kernel(Level L, int k,
                                                         int zero) {
  const int b = blockIdx.y, hw = L.H * L.W, H = L.H, W = L.W, C = L.C;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= hw || !active(L, k, b)) return;
  const int y = p / W, x = p - y * W;
  const size_t base = (size_t)b * hw;
  const size_t i = base + p;
  const float* im1 = L.im1 + base * C;
  const float* wp = L.warped + base * C;

  float a11 = 0.f, a12 = 0.f, a22 = 0.f, b1 = 0.f, b2 = 0.f;
  for (int c = 0; c < C; ++c) {
    const size_t q = (size_t)p * C + c;
    const float mc = 0.5f * (im1[q] + wp[q]);
    const float mxp = x < W - 1 ? 0.5f * (im1[q + C] + wp[q + C]) : mc;
    const float mxm = x > 0 ? 0.5f * (im1[q - C] + wp[q - C]) : mc;
    const size_t row = (size_t)W * C;
    const float myp = y < H - 1 ? 0.5f * (im1[q + row] + wp[q + row]) : mc;
    const float mym = y > 0 ? 0.5f * (im1[q - row] + wp[q - row]) : mc;
    const float ix = 0.5f * (mxp - mxm);
    const float iy = 0.5f * (myp - mym);
    const float it = wp[q] - im1[q];
    const float psi = 1.f / sqrtf(it * it + L.eps);
    a11 = a11 + psi * ix * ix;
    a12 = a12 + psi * ix * iy;
    a22 = a22 + psi * iy * iy;
    b1 = b1 - psi * ix * it;
    b2 = b2 - psi * iy * it;
  }

  const float* phi = field(L, PHI) + base;
  const float ph = phi[p];
  const float wu = y == 0 ? 0.f : 0.5f * (ph + phi[p - W]);
  const float wd = y >= H - 1 ? 0.f : 0.5f * (ph + phi[p + W]);
  const float wl = x == 0 ? 0.f : 0.5f * (ph + phi[p - 1]);
  const float wr = x >= W - 1 ? 0.f : 0.5f * (ph + phi[p + 1]);
  const float wsum = wu + wd + wl + wr;

  const float* u = L.u + base;
  const float* v = L.v + base;
  const float u_up = y > 0 ? u[p - W] : 0.f, u_dn = y < H - 1 ? u[p + W] : 0.f;
  const float u_lf = x > 0 ? u[p - 1] : 0.f, u_rt = x < W - 1 ? u[p + 1] : 0.f;
  const float v_up = y > 0 ? v[p - W] : 0.f, v_dn = y < H - 1 ? v[p + W] : 0.f;
  const float v_lf = x > 0 ? v[p - 1] : 0.f, v_rt = x < W - 1 ? v[p + 1] : 0.f;
  const float nu = wu * u_up + wd * u_dn + wl * u_lf + wr * u_rt;
  const float nv = wu * v_up + wd * v_dn + wl * v_lf + wr * v_rt;

  field(L, A12)[i] = a12;
  field(L, B1)[i] = b1;
  field(L, B2)[i] = b2;
  field(L, WU)[i] = wu;
  field(L, WD)[i] = wd;
  field(L, WL)[i] = wl;
  field(L, WR)[i] = wr;
  field(L, INVU)[i] = 1.f / (a11 + L.alpha * wsum);
  field(L, INVV)[i] = 1.f / (a22 + L.alpha * wsum);
  field(L, NUC)[i] = nu - wsum * u[p];
  field(L, NVC)[i] = nv - wsum * v[p];
  field(L, zero)[i] = 0.f;
  field(L, zero + 1)[i] = 0.f;
}

struct ActivePairs {
  Level L;
  int k;
  __device__ bool operator()(int b) const { return active(L, k, b); }
};

// n SOR half-sweeps of the tiles of the pairs that run outer k, from F's
// (du, dv) into (du, dv).
__global__ void __launch_bounds__(sor_tiles::kThreads, 1)
flow_level_sor_tile_kernel(Level L, int k, sor_tiles::Fields F, float* du,
                           float* dv, sor_tiles::Plan P, int n) {
  extern __shared__ float smem[];
  sor_tiles::run_tiles(smem, F, du, dv, P, L.B, L.H, L.W, n, L.alpha, L.omega,
                       L.one_m_omega, ActivePairs{L, k});
}

// u += du, v += dv; per-pair max|du, dv| (the early-exit test) and the next
// outer's max|flow|; mx takes this outer's pre-clamp max|flow|.
__global__ void __launch_bounds__(kThreads) finish_kernel(Level L, int k) {
  const int b = blockIdx.y, hw = L.H * L.W;
  if (!active(L, k, b)) return;  // uniform over the block
  const int p = blockIdx.x * kThreads + threadIdx.x;
  float md = 0.f, mf = 0.f;
  if (p < hw) {
    const size_t i = (size_t)b * hw + p;
    const float du = field(L, DU)[i], dv = field(L, DV)[i];
    const float un = L.u[i] + du, vn = L.v[i] + dv;
    L.u[i] = un;
    L.v[i] = vn;
    md = fmaxf(fabsf(du), fabsf(dv));
    mf = fmaxf(fabsf(un), fabsf(vn));
  }
  md = block_max(md);
  mf = block_max(mf);
  if (threadIdx.x == 0) {
    atomic_max_nonneg(delta(L, k) + b, md);
    atomic_max_nonneg(maxflow(L, k + 1) + b, mf);
    if (blockIdx.x == 0) L.mx[b] = fmaxf(L.mx[b], maxflow(L, k)[b]);
  }
}

}  // namespace

// Launches the whole level on `stream`; the binding (bindings.cpp) allocates
// the scratch: fields (flow_level_num_fields() x B x H x W), warped (like
// im1) and red ((2 n_outer + 1) x B, zeroed), and mx (B,), zeroed.
cudaError_t flow_level_launch(const float* im1, const float* im2, float* u,
                              float* v, float* mx, float* fields,
                              float* warped, float* red, int B, int H, int W,
                              int C, int n_outer, int n_sor, float alpha,
                              float omega, float one_m_omega, float eps,
                              int r_cap, float outer_tol, cudaStream_t st) {
  if (B <= 0 || H < 2 || W < 2 || C <= 0 || n_sor < 0)
    return cudaErrorInvalidValue;
  const Level L{im1, im2, u, v, mx, fields, warped, red, B, H, W, C, n_outer,
                r_cap, alpha, omega, one_m_omega, eps, outer_tol};
  const size_t n = (size_t)B * H * W;
  const dim3 px_grid((H * W + kThreads - 1) / kThreads, B);
  const int n_half = 2 * n_sor;
  const sor_tiles::Plan P = sor_tiles::plan(H, W, n_half);
  const int tile_grid = sor_tiles::grid_blocks(P, B);
  // The SOR starts from zeros in the pair that is not its first destination
  // and ends in (DU, DV), where finish_kernel reads.
  const int zero = sor_tiles::num_launches(P, n_half) % 2 ? DU2 : DU;
  sor_tiles::Fields F;
  for (int f = A12; f <= NVC; ++f) F.f[f] = fields + f * n;
  cudaError_t err = cudaFuncSetAttribute(
      flow_level_sor_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      sor_tiles::kSmemBytes);
  if (err != cudaSuccess) return err;
  maxflow_init_kernel<<<px_grid, kThreads, 0, st>>>(L);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (int k = 0; k < n_outer; ++k) {
    warp_phi_kernel<<<px_grid, kThreads, 0, st>>>(L, k);
    coeff_kernel<<<px_grid, kThreads, 0, st>>>(L, k, zero);
    err = sor_tiles::run_schedule(
        P, n_half, fields + zero * n, fields + (zero + 1) * n, fields + DU * n,
        fields + DV * n, fields + DU2 * n, fields + DV2 * n,
        [&](const float* sdu, const float* sdv, float* ddu, float* ddv,
            int count) {
          F.f[sor_tiles::DU] = sdu;
          F.f[sor_tiles::DV] = sdv;
          flow_level_sor_tile_kernel<<<tile_grid, sor_tiles::kThreads,
                                       sor_tiles::kSmemBytes, st>>>(
              L, k, F, ddu, ddv, P, count);
        });
    if (err != cudaSuccess) return err;
    finish_kernel<<<px_grid, kThreads, 0, st>>>(L, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

int flow_level_num_fields() { return kNumFields; }
