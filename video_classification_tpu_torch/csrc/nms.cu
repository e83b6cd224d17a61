// Greedy non-maximum suppression with a fixed output count, one frame per
// block.
//
// Replaces the Pallas TPU kernel video_classification_tpu/detect/pallas_nms.py
// `_nms_kernel` (entry point `nms_pallas`), whose results equal the XLA
// version detect/ops.py `nms`. Per frame, max_out iterations: take the live
// box of the highest score (the first index on ties); it is valid iff its
// score > NEG/2 (NEG = -3e38, the suppressed sentinel); slot i gets
// (index, true), or (0, false) when not valid; then every box whose IoU with
// it exceeds thr, and the box itself, is suppressed (score -> NEG). IoU uses
// areas max(x2-x1, 0) * max(y2-y1, 0) and inter / max(area + barea - inter,
// 1e-9), in the plain twin's operation order (detect/nms.py::nms_reference);
// built with -fmad=false and IEEE division, the indices come out identical.
//
// Design. One block per frame keeps the frame's boxes, areas and live scores
// in shared memory (24 bytes per box: 30 KB at the serving N = 1264, 120 KB
// at N = 5000). Each thread owns the boxes j = tid, tid + T, ... and keeps
// the best (score, index) of its own boxes; the argmax of an iteration is a
// warp-shuffle reduction plus one pass over the per-warp results, which
// every thread reads from a double-buffered array after one barrier, so an
// iteration costs a single __syncthreads. The suppression of iteration i and
// the local argmax of iteration i + 1 are one pass. Once a slot is not
// valid, no later slot can be (nothing changes any more), so the block
// writes the remaining slots as (0, false) and stops.
//
// Bound. The device-memory traffic is tiny (20 B per box in, 5 B per slot
// out); the operations are ~16 per box per executed iteration. The real
// limit is latency: max_out dependent block-wide reductions per frame, each
// a barrier and a few shuffles, on as many SMs as there are frames.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr float kNeg = -3.0e38f;

__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

__global__ void __launch_bounds__(kMaxThreads)
nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
           int32_t* __restrict__ idx_out, bool* __restrict__ mask_out, int N,
           int max_out, float thr) {
  extern __shared__ float smem[];
  float* x1 = smem;
  float* y1 = x1 + N;
  float* x2 = y1 + N;
  float* y2 = x2 + N;
  float* area = y2 + N;
  float* live = area + N;
  __shared__ float red_s[2][kMaxWarps];
  __shared__ int red_i[2][kMaxWarps];

  const int tid = threadIdx.x, nthreads = blockDim.x, nwarps = nthreads / 32;
  const float* bx = boxes + (size_t)blockIdx.x * N * 4;
  const float* sc = scores + (size_t)blockIdx.x * N;
  int32_t* io = idx_out + (size_t)blockIdx.x * max_out;
  bool* mo = mask_out + (size_t)blockIdx.x * max_out;

  float bs = -INFINITY;
  int bi = INT_MAX;
  for (int j = tid; j < N; j += nthreads) {
    const float a = bx[4 * j], b = bx[4 * j + 1], c = bx[4 * j + 2],
                d = bx[4 * j + 3];
    x1[j] = a;
    y1[j] = b;
    x2[j] = c;
    y2[j] = d;
    area[j] = fmaxf(c - a, 0.f) * fmaxf(d - b, 0.f);
    const float s = sc[j];
    live[j] = s;
    if (better(s, j, bs, bi)) {
      bs = s;
      bi = j;
    }
  }

  for (int it = 0; it < max_out; ++it) {
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_down_sync(0xffffffffu, bs, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(os, oi, bs, bi)) {
        bs = os;
        bi = oi;
      }
    }
    const int buf = it & 1;
    if ((tid & 31) == 0) {
      red_s[buf][tid >> 5] = bs;
      red_i[buf][tid >> 5] = bi;
    }
    // Also orders the first iteration after the shared-memory fill.
    __syncthreads();
    float best_s = red_s[buf][0];
    int best = red_i[buf][0];
    for (int w = 1; w < nwarps; ++w) {
      if (better(red_s[buf][w], red_i[buf][w], best_s, best)) {
        best_s = red_s[buf][w];
        best = red_i[buf][w];
      }
    }
    const bool valid = best_s > kNeg * 0.5f;
    if (tid == 0) {
      io[it] = valid ? best : 0;
      mo[it] = valid;
    }
    if (!valid) {  // the same decision in every thread
      for (int k = it + 1 + tid; k < max_out; k += nthreads) {
        io[k] = 0;
        mo[k] = false;
      }
      return;
    }
    const float bx1 = x1[best], by1 = y1[best], bx2 = x2[best],
                by2 = y2[best], barea = area[best];
    bs = -INFINITY;
    bi = INT_MAX;
    for (int j = tid; j < N; j += nthreads) {
      float s = live[j];
      const float iw = fmaxf(fminf(x2[j], bx2) - fmaxf(x1[j], bx1), 0.f);
      const float ih = fmaxf(fminf(y2[j], by2) - fmaxf(y1[j], by1), 0.f);
      const float inter = iw * ih;
      const float iou = inter / fmaxf(area[j] + barea - inter, 1e-9f);
      if (iou > thr || j == best) {
        s = kNeg;
        live[j] = s;
      }
      if (better(s, j, bs, bi)) {
        bs = s;
        bi = j;
      }
    }
  }
}

}  // namespace

// Bytes of shared memory one frame of N boxes needs.
int64_t nms_smem_bytes(int64_t N) { return 6 * 4 * N; }

// Launches one block per frame on `stream`: boxes (B, N, 4) xyxy float32,
// scores (B, N) float32 -> idx (B, max_out) int32, mask (B, max_out) bool.
cudaError_t nms_launch(const float* boxes, const float* scores, int32_t* idx,
                       bool* mask, int B, int N, int max_out, float thr,
                       cudaStream_t st) {
  if (B <= 0 || N <= 0 || max_out <= 0) return cudaErrorInvalidValue;
  const int threads = N >= kMaxThreads ? kMaxThreads : (N + 31) / 32 * 32;
  const size_t smem = (size_t)nms_smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  nms_kernel<<<B, threads, smem, st>>>(boxes, scores, idx, mask, N, max_out,
                                       thr);
  return cudaGetLastError();
}
