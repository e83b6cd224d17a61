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
// 240x320), more than the 227 KB of shared memory of one H100 block. A setup
// launch writes the hoisted fields to scratch; the half-sweeps then run in
// on-chip tiles (sor_tiles.cuh): each tiled launch loads 64x64 windows of the
// 13 fields once, runs 12 half-sweeps with the 11 read-only fields in
// registers and (du, dv) in shared memory, and writes the 40x40 interiors,
// reading (du, dv) from one buffer and writing the other; persistent blocks
// stage the next tile's fields while the current one computes. A frame of
// at most 64x64 (43x57 and below) is one tile, all half-sweeps in one
// launch. A 30-sweep solve is 1 + 5 launches at 240x320 (48 tiles x 101
// pairs each) and 2 launches at 43x57.
//
// Bound. The bytes bound reads the 13 inputs once and writes (du, dv) once;
// what the half-sweeps move is the tiles' loads, 13 fields over 2.56x the
// frame per 12 half-sweeps at 240x320 (before: 15 fields per half-sweep), and
// 12 shared-memory words per updated pixel.
//
// Built with -fmad=false: every product and sum is rounded as in the plain
// PyTorch twin (ops/sor_solve.py::sor_solve_reference), in the same order.

#include <cuda_runtime.h>

#include "sor_tiles.cuh"

namespace {

constexpr int kThreads = 256;

struct Setup {
  const float *a11, *a22, *wu, *wd, *wl, *wr, *u, *v;
  float *inv_u, *inv_v, *nuc, *nvc;  // scratch, (B, H, W) each
  int H, W;
  float alpha;
};

// The hoisted fields.
__global__ void __launch_bounds__(kThreads) sor_solve_setup_kernel(Setup S) {
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
}

struct AllPairs {
  __device__ bool operator()(int) const { return true; }
};

// n half-sweeps of every tile of the batch.
__global__ void __launch_bounds__(sor_tiles::kThreads, 1)
sor_solve_tile_kernel(sor_tiles::Fields F, float* du, float* dv,
                      sor_tiles::Plan P, int B, int H, int W, int n,
                      float alpha, float omega, float one_m_omega) {
  extern __shared__ float smem[];
  sor_tiles::run_tiles(smem, F, du, dv, P, B, H, W, n, alpha, omega,
                       one_m_omega, AllPairs{});
}

}  // namespace

// The schedule compiled into sor_tiles.cuh: tile rows, tile columns,
// half-sweeps per tiled launch.
void sor_tiles_schedule(int out[3]) {
  out[0] = sor_tiles::kTileH;
  out[1] = sor_tiles::kTileW;
  out[2] = sor_tiles::kHalfSweeps;
}

// Launches the solve on `stream`. fields: the 13 inputs (a11, a12, a22, b1,
// b2, wu, wd, wl, wr, u, v, du0, dv0), each (B, H, W) contiguous float32;
// scratch: 6 x (B, H, W) floats (4 hoisted fields, 2 ping-pong buffers);
// du, dv: the (B, H, W) outputs.
cudaError_t sor_solve_launch(const float* const* fields, float* scratch,
                             float* du, float* dv, int B, int H, int W,
                             int n_sor, float alpha, float omega,
                             float one_m_omega, cudaStream_t st) {
  if (B <= 0 || H <= 0 || W <= 0 || n_sor < 0)
    return cudaErrorInvalidValue;
  const size_t n = (size_t)B * H * W;
  float* inv_u = scratch;
  float* inv_v = scratch + n;
  float* nuc = scratch + 2 * n;
  float* nvc = scratch + 3 * n;
  const int n_half = 2 * n_sor;
  if (n_half == 0) {
    cudaError_t err = cudaMemcpyAsync(du, fields[11], n * sizeof(float),
                                      cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return err;
    return cudaMemcpyAsync(dv, fields[12], n * sizeof(float),
                           cudaMemcpyDeviceToDevice, st);
  }
  const Setup S{fields[0], fields[2], fields[5], fields[6], fields[7],
                fields[8], fields[9], fields[10], inv_u, inv_v, nuc, nvc,
                H, W, alpha};
  sor_solve_setup_kernel<<<dim3((H * W + kThreads - 1) / kThreads, B),
                           kThreads, 0, st>>>(S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const sor_tiles::Plan P = sor_tiles::plan(H, W, n_half);
  err = cudaFuncSetAttribute(sor_solve_tile_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sor_tiles::kSmemBytes);
  if (err != cudaSuccess) return err;
  sor_tiles::Fields F{{fields[1], fields[3], fields[4], fields[5], fields[6],
                       fields[7], fields[8], inv_u, inv_v, nuc, nvc, nullptr,
                       nullptr}};
  const int grid = sor_tiles::grid_blocks(P, B);
  return sor_tiles::run_schedule(
      P, n_half, fields[11], fields[12], du, dv, scratch + 4 * n,
      scratch + 5 * n,
      [&](const float* sdu, const float* sdv, float* ddu, float* ddv,
          int count) {
        F.f[sor_tiles::DU] = sdu;
        F.f[sor_tiles::DV] = sdv;
        sor_solve_tile_kernel<<<grid, sor_tiles::kThreads,
                                sor_tiles::kSmemBytes, st>>>(
            F, ddu, ddv, P, B, H, W, count, alpha, omega, one_m_omega);
      });
}
