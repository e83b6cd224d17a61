// One pyramid level of the variational optical-flow solver, for all frame
// pairs of a batch at once.
//
// Replaces the Pallas TPU kernel video_classification_tpu/ops/pallas_flow.py
// `_flow_level_kernel` (entry point `flow_level_fused_pallas`). Same
// semantics: n_outer fixed-point relinearisations, each a bilinear warp of
// im2 by (u, v) with offsets clamped to +-r, r = clip(ceil(max|flow|), 1,
// r_cap) taken per pair from that outer's pre-clamp max, and the base corner
// clamped to (h-2, w-2); IRLS data terms from the gradient of
// 0.5*(im1 + warped) with psi = rsqrt(it^2 + eps); Charbonnier half-point
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
// coefficient kernel, one launch of all 2 n_sor SOR half-sweeps, and one
// finish kernel that adds the increments and reduces max|du,dv| and
// max|flow| per pair with atomics. The SOR holds each frame on the chip for
// the whole outer (sor_resident.cuh): one thread-block cluster a pair, a
// strip of rows a CTA, the strip's read-only fields and (du, dv) in shared
// memory, each strip's edge cells sent through distributed shared memory
// as soon as a half-sweep has computed them; 16 CTAs at most
// (sor_resident::plan), which hold every level of the serving, offline and
// v2 pyramids (up to 240x320; at 320 columns, up to 256 rows). A frame of
// at most 64x64 runs as one block, all half-sweeps in one launch
// (sor_tiles.cuh's whole frame, shared with sor_solve.cu); a frame no
// cluster holds takes the SOR tiles' schedule (12 half-sweeps per launch
// on 64x64 windows, each launch staging its windows' fields again).
// Converged pairs are switched off by per-pair flags that every kernel
// reads from device memory, so a level never syncs the host.
//
// Bound. The kernel's bound is its ~1e3 f32 operations per pixel per outer
// (inputs and outputs are a few fields). What the SOR moves: each outer
// loads 9 fields and writes 2 once per cell (the tiles loaded 13 fields
// over 2.29x the frame once per 12 half-sweeps at 240x320); each updated
// cell reads 21 shared-memory words (its 11 coefficients, its own and 8
// neighbouring increments) and writes 2, and every half-sweep waits for the
// exchange of the one before: at 101 pairs of 240x320, 7 clusters of 16
// CTAs run at once, in 15 waves per outer.
//
// Built with -fmad=false, so nvcc contracts nothing on its own: the fused
// multiply-adds are the __fmaf_rn of the plain PyTorch twin's fma_f32
// (ops/flow_level.py::flow_level_reference, XLA:CPU's contractions of the
// Pallas kernel), psi and phi are the correctly rounded __frsqrt_rn of its
// rsqrt_f32, and every other product and sum is rounded as there, in the
// same order.

#include <cuda_runtime.h>

#include "sor_resident.cuh"
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
  // The select-shift sum of the Pallas kernel: its nonzero terms, the four
  // corners, each fused into the running sum.
  for (int c = 0; c < C; ++c) {
    float acc = im2[c00 + c] * w00;
    acc = __fmaf_rn(im2[c00 + C + c], w01, acc);
    acc = __fmaf_rn(im2[c10 + c], w10, acc);
    acc = __fmaf_rn(im2[c10 + C + c], w11, acc);
    L.warped[i * C + c] = acc;
  }

  const int xp = x < W - 1 ? x + 1 : x, xm = x > 0 ? x - 1 : x;
  const int yp = y < H - 1 ? y + 1 : y, ym = y > 0 ? y - 1 : y;
  const float ux = 0.5f * (u[y * W + xp] - u[y * W + xm]);
  const float uy = 0.5f * (u[yp * W + x] - u[ym * W + x]);
  const float vx = 0.5f * (v[y * W + xp] - v[y * W + xm]);
  const float vy = 0.5f * (v[yp * W + x] - v[ym * W + x]);
  const float mag =
      __fmaf_rn(vy, vy, __fmaf_rn(vx, vx, __fmaf_rn(ux, ux, uy * uy)));
  field(L, PHI)[i] = __frsqrt_rn(mag + L.eps);
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
    const float psi = __frsqrt_rn(__fmaf_rn(it, it, L.eps));
    const float px = psi * ix, py = psi * iy;
    a11 = __fmaf_rn(px, ix, a11);
    a12 = __fmaf_rn(px, iy, a12);
    a22 = __fmaf_rn(py, iy, a22);
    b1 = __fmaf_rn(-px, it, b1);
    b2 = __fmaf_rn(-py, it, b2);
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
  using sor_tiles::weighted_sum;
  const float nu = weighted_sum(wu, wd, wl, wr, u_up, u_dn, u_lf, u_rt);
  const float nv = weighted_sum(wu, wd, wl, wr, v_up, v_dn, v_lf, v_rt);

  field(L, A12)[i] = a12;
  field(L, B1)[i] = b1;
  field(L, B2)[i] = b2;
  field(L, WU)[i] = wu;
  field(L, WD)[i] = wd;
  field(L, WL)[i] = wl;
  field(L, WR)[i] = wr;
  field(L, INVU)[i] = sor_tiles::inv_diagonal(a11, L.alpha, wsum);
  field(L, INVV)[i] = sor_tiles::inv_diagonal(a22, L.alpha, wsum);
  field(L, NUC)[i] = sor_tiles::smoothness_constant(nu, wsum, u[p]);
  field(L, NVC)[i] = sor_tiles::smoothness_constant(nv, wsum, v[p]);
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

// All n SOR half-sweeps of the pairs that run outer k, each frame resident
// in one cluster (sor_resident.cuh), from zero into (du, dv).
__global__ void __launch_bounds__(sor_resident::kThreads, 1)
flow_level_sor_resident_kernel(Level L, int k, sor_resident::Args A) {
  extern __shared__ float smem[];
  sor_resident::run(smem, A, ActivePairs{L, k});
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

// The resident SOR's launch configuration for B pairs of H x W; attr is
// the cluster dimension it points to.
cudaLaunchConfig_t resident_config(const sor_resident::Plan& RP, int B, int W,
                                   cudaLaunchAttribute& attr, cudaStream_t st) {
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = RP.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * RP.cluster);
  cfg.blockDim = dim3(sor_resident::kThreads);
  cfg.dynamicSmemBytes = sor_resident::smem_bytes(RP.rows, W);
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t set_resident_attributes(const sor_resident::Plan& RP, int W) {
  cudaError_t err = cudaFuncSetAttribute(
      flow_level_sor_resident_kernel,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(flow_level_sor_resident_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sor_resident::smem_bytes(RP.rows, W));
}

}  // namespace

// Launches the whole level on `stream`; the binding (bindings.cpp) allocates
// the scratch: fields (flow_level_num_fields() x B x H x W), warped (like
// im1) and red ((2 n_outer + 1) x B, zeroed), and mx (B,), zeroed. The SOR
// holds each frame on the chip where sor_resident::plan finds a cluster for
// it and the frame is larger than one SOR tile, unless `tiled` asks for the
// SOR tiles' schedule (the comparison of the two on the card).
cudaError_t flow_level_launch(const float* im1, const float* im2, float* u,
                              float* v, float* mx, float* fields,
                              float* warped, float* red, int B, int H, int W,
                              int C, int n_outer, int n_sor, float alpha,
                              float omega, float one_m_omega, float eps,
                              int r_cap, float outer_tol, bool tiled,
                              cudaStream_t st) {
  if (B <= 0 || H < 2 || W < 2 || C <= 0 || n_sor < 0)
    return cudaErrorInvalidValue;
  const Level L{im1, im2, u, v, mx, fields, warped, red, B, H, W, C, n_outer,
                r_cap, alpha, omega, one_m_omega, eps, outer_tol};
  const size_t n = (size_t)B * H * W;
  const dim3 px_grid((H * W + kThreads - 1) / kThreads, B);
  const int n_half = 2 * n_sor;
  const sor_tiles::Plan P = sor_tiles::plan(H, W, n_half);
  const sor_resident::Plan RP = sor_resident::plan(H, W);
  const bool resident =
      !tiled && !sor_tiles::whole_frame(H, W) && RP.cluster > 0;
  const int tile_grid = sor_tiles::grid_blocks(P, B);
  // The tiles start from zeros in the pair that is not their first
  // destination and end in (DU, DV), where finish_kernel reads; the
  // resident SOR starts from zero on the chip and writes (DU, DV), so the
  // coefficient kernel's zeros go to (DU2, DV2), unread.
  const int zero =
      resident || sor_tiles::num_launches(P, n_half) % 2 ? DU2 : DU;
  sor_tiles::Fields F;
  for (int f = A12; f <= NVC; ++f) F.f[f] = fields + f * n;
  sor_resident::Args A;
  const Field on_chip[sor_resident::kCoeffs] = {A12, B1,  B2,  WL, INVU,
                                                INVV, NUC, NVC, WU};
  for (int f = 0; f < sor_resident::kCoeffs; ++f)
    A.f[f] = fields + on_chip[f] * n;
  A.du = fields + DU * n;
  A.dv = fields + DV * n;
  A.H = H;
  A.W = W;
  A.rows = RP.rows;
  A.n = n_half;
  A.alpha = alpha;
  A.omega = omega;
  A.one_m_omega = one_m_omega;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = resident_config(RP, B, W, attr, st);
  cudaError_t err =
      resident ? set_resident_attributes(RP, W)
               : cudaFuncSetAttribute(
                     flow_level_sor_tile_kernel,
                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                     sor_tiles::kSmemBytes);
  if (err != cudaSuccess) return err;
  maxflow_init_kernel<<<px_grid, kThreads, 0, st>>>(L);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (int k = 0; k < n_outer; ++k) {
    warp_phi_kernel<<<px_grid, kThreads, 0, st>>>(L, k);
    coeff_kernel<<<px_grid, kThreads, 0, st>>>(L, k, zero);
    if (resident) {
      err = cudaLaunchKernelEx(&cfg, flow_level_sor_resident_kernel, L, k, A);
      if (err == cudaSuccess) err = cudaGetLastError();
    } else {
      err = sor_tiles::run_schedule(
          P, n_half, fields + zero * n, fields + (zero + 1) * n,
          fields + DU * n, fields + DV * n, fields + DU2 * n,
          fields + DV2 * n,
          [&](const float* sdu, const float* sdv, float* ddu, float* ddv,
              int count) {
            F.f[sor_tiles::DU] = sdu;
            F.f[sor_tiles::DV] = sdv;
            flow_level_sor_tile_kernel<<<tile_grid, sor_tiles::kThreads,
                                         sor_tiles::kSmemBytes, st>>>(
                L, k, F, ddu, ddv, P, count);
          });
    }
    if (err != cudaSuccess) return err;
    finish_kernel<<<px_grid, kThreads, 0, st>>>(L, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

int flow_level_num_fields() { return kNumFields; }

// The resident SOR's plan for H x W, {CTAs per frame, rows per CTA}; {0, 0}
// where no cluster holds the frame.
void flow_level_resident_plan(int H, int W, int out[2]) {
  const sor_resident::Plan RP = sor_resident::plan(H, W);
  out[0] = RP.cluster;
  out[1] = RP.rows;
}

// Clusters of the resident SOR at H x W that the card runs at once
// (cudaOccupancyMaxActiveClusters); 0 where no cluster holds the frame, -1
// on an error.
int flow_level_active_clusters(int H, int W) {
  const sor_resident::Plan RP = sor_resident::plan(H, W);
  if (RP.cluster == 0) return 0;
  if (set_resident_attributes(RP, W) != cudaSuccess) return -1;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = resident_config(RP, RP.cluster, W, attr, 0);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, flow_level_sor_resident_kernel,
                                     &cfg) != cudaSuccess)
    return -1;
  return clusters;
}
