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
// The same result as a scan. Taking the argmax of the live scores, first
// index on ties, visits the boxes in the order (score descending, index
// ascending). A box is kept iff its score is > NEG/2 and no box kept before
// it has IoU > thr with it; the scan stops at max_out kept boxes or at the
// first score <= NEG/2, and the remaining slots are (0, false). The IoU test
// is the same expression whichever box is "best": min, max and + commute
// exactly in IEEE arithmetic. NaN scores are outside the contract (the
// twin's torch.argmax and this kernel may order them differently).
//
// Bound. The device-memory traffic is tiny (20 B per box in, 5 B per slot
// out) and the operations few; what costs is the chain of dependent steps.
// The argmax form has max_out block-wide reductions, one barrier each.
//
// Design. One block per frame (latency is what matters).
// - Load the boxes into shared memory and sort 64-bit keys (the score's
//   order-preserving bits, descending, -0.0 mapped to +0.0; then the index,
//   ascending) by a bitonic sort padded to a power of two: a warp sorts
//   64-key segments in registers (strides below 32 by shuffles, 32 within a
//   thread); only the strides of 64 and more of the later phases go through
//   shared memory with a barrier each.
// - Walk the sorted list in chunks of 64 candidates. Eight threads per
//   candidate test it against every kept box and build its row of the
//   chunk's upper-triangular 64x64 "suppresses" bit matrix; after one
//   barrier a single lane resolves the chunk on a 64-bit word (keep the
//   lowest live bit, clear its row, repeat), then warp 0 appends the kept
//   boxes. Two barriers per chunk instead of one per kept box.
// Shared memory: 16 B of box and 4 B of kept index per box, 8 B of key per
// padded position: 41 KB at the serving N = 1264, 162 KB at N = 5000, at
// most N = 8192 (nms_smem_bytes <= one block's 232,448 bytes).
// Past that, the device-memory route: the same kernel with the keys sorted in
// a scratch array in device memory (the same bitonic network: a barrier
// orders a block's device-memory writes as it does its shared ones), the
// kept indices in device memory and the boxes read where they lie. The
// scratch is 8 B per padded key and 4 B per slot a frame; the keys of a frame
// (256 KB at N = 20000) stay in the 50 MB L2.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;
constexpr int kPerCandidate = kThreads / kChunk;
constexpr float kNeg = -3.0e38f;

__device__ __forceinline__ uint64_t sort_key(float s, int i) {
  uint32_t b = __float_as_uint(s);
  if ((b << 1) == 0) b = 0;  // -0.0 ties with +0.0
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);  // ascending with s
  return (uint64_t)(~b) << 32 | (uint32_t)i;
}

__device__ __forceinline__ float key_score(uint64_t key) {
  const uint32_t b = ~(uint32_t)(key >> 32);
  return __uint_as_float((b & 0x80000000u) ? (b & 0x7FFFFFFFu) : ~b);
}

__device__ __forceinline__ float area_of(float4 b) {
  return fmaxf(b.z - b.x, 0.f) * fmaxf(b.w - b.y, 0.f);
}

// IoU(j, k) > thr, with j as the twin's candidate and k as its best box.
__device__ __forceinline__ bool overlaps(float4 j, float aj, float4 k, float ak,
                                         float thr) {
  const float iw = fmaxf(fminf(j.z, k.z) - fmaxf(j.x, k.x), 0.f);
  const float ih = fmaxf(fminf(j.w, k.w) - fmaxf(j.y, k.y), 0.f);
  const float inter = iw * ih;
  return inter / fmaxf(aj + ak - inter, 1e-9f) > thr;
}

// One compare-exchange stage (phase k, stride j < 32) on the key a lane
// holds at position p, against the lane j apart.
__device__ __forceinline__ uint64_t shuffle_stage(uint64_t a, int p, int k,
                                                  int j) {
  const uint64_t o = __shfl_xor_sync(0xffffffffu, a, j);
  const bool keep_min = ((p & j) == 0) == ((p & k) == 0);
  return keep_min ? (o < a ? o : a) : (o > a ? o : a);
}

// Phases k_lo..k_hi (powers of two), strides min(k/2, 32) down to 1, on
// every 64-key segment, a warp per segment, the keys in registers.
__device__ void segment_stages(uint64_t* keys, int n, int k_lo, int k_hi) {
  const int lane = threadIdx.x & 31;
  for (int seg = threadIdx.x >> 5; seg < n / 64; seg += kWarps) {
    const int p0 = seg * 64 + lane, p1 = p0 + 32;
    uint64_t a = keys[p0], b = keys[p1];
    for (int k = k_lo; k <= k_hi; k <<= 1) {
      if (k >= 64 && ((a > b) == ((p0 & k) == 0))) {
        const uint64_t t = a;
        a = b;
        b = t;
      }
      for (int j = (k >= 64 ? 32 : k) >> 1; j > 0; j >>= 1) {
        a = shuffle_stage(a, p0, k, j);
        b = shuffle_stage(b, p1, k, j);
      }
    }
    keys[p0] = a;
    keys[p1] = b;
  }
}

// Sorts keys[0, n) ascending, n a power of two >= 64.
__device__ void bitonic_sort(uint64_t* keys, int n) {
  segment_stages(keys, n, 2, 64);
  __syncthreads();
  for (int k = 128; k <= n; k <<= 1) {
    for (int j = k >> 1; j >= 64; j >>= 1) {
      for (int i = threadIdx.x; i < n / 2; i += kThreads) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1)), hi = lo + j;
        const uint64_t a = keys[lo], b = keys[hi];
        if ((a > b) == ((lo & k) == 0)) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
    segment_stages(keys, n, k, k);
    __syncthreads();
  }
}

__device__ __forceinline__ float4 load_box(const float* bx, int j) {
  return make_float4(bx[4 * j], bx[4 * j + 1], bx[4 * j + 2], bx[4 * j + 3]);
}

// kShared: boxes, keys and kept indices in shared memory (N <= 8192); else
// keys and kept indices in `scratch` (device memory), boxes read from `boxes`.
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
nms_sorted_kernel(const float* __restrict__ boxes,
                  const float* __restrict__ scores, int32_t* __restrict__ idx_out,
                  bool* __restrict__ mask_out, uint64_t* __restrict__ scratch,
                  int N, int n_pad, int max_out, float thr) {
  extern __shared__ float4 smem[];
  __shared__ uint64_t rows[kChunk];
  __shared__ bool candidate[kChunk];
  __shared__ int n_kept_s;

  const int tid = threadIdx.x, lane = tid & 31;
  const float* bx = boxes + (size_t)blockIdx.x * N * 4;
  const float* sc = scores + (size_t)blockIdx.x * N;
  int32_t* io = idx_out + (size_t)blockIdx.x * max_out;
  bool* mo = mask_out + (size_t)blockIdx.x * max_out;
  float4* box = smem;
  uint64_t* keys;
  int* kept;
  if (kShared) {
    keys = reinterpret_cast<uint64_t*>(box + N);
    kept = reinterpret_cast<int*>(keys + n_pad);
  } else {
    uint64_t* frame = scratch + (size_t)blockIdx.x * (n_pad + (max_out + 1) / 2);
    keys = frame;
    kept = reinterpret_cast<int*>(frame + n_pad);
  }
  auto box_at = [&](int j) { return kShared ? box[j] : load_box(bx, j); };

  for (int j = tid; j < n_pad; j += kThreads) {
    if (j < N) {
      if (kShared) box[j] = load_box(bx, j);
      keys[j] = sort_key(sc[j], j);
    } else {
      keys[j] = ~0ull;
    }
  }
  __syncthreads();
  bitonic_sort(keys, n_pad);

  const int t = tid / kPerCandidate, sub = tid % kPerCandidate;
  int n_kept = 0;
  for (int base = 0; base < N && n_kept < max_out; base += kChunk) {
    const int pos = base + t;
    bool live = false;
    uint64_t row = 0;
    if (pos < N && key_score(keys[pos]) > kNeg * 0.5f) {
      const float4 bt = box_at((uint32_t)keys[pos]);
      const float at = area_of(bt);
      live = true;
      for (int k = sub; k < n_kept && live; k += kPerCandidate) {
        const float4 kb = box_at(kept[k]);
        live = !overlaps(bt, at, kb, area_of(kb), thr);
      }
      for (int o = t + 1 + sub; o < kChunk && base + o < N; o += kPerCandidate) {
        const float4 ob = box_at((uint32_t)keys[base + o]);
        if (overlaps(ob, area_of(ob), bt, at, thr)) row |= 1ull << o;
      }
    }
    // The eight threads of a candidate are neighbouring lanes.
    bool suppressed = pos < N && !live;
    for (int m = 1; m < kPerCandidate; m <<= 1) {
      row |= __shfl_xor_sync(0xffffffffu, row, m);
      suppressed |= __shfl_xor_sync(0xffffffffu, (int)suppressed, m);
    }
    if (sub == 0) {
      rows[t] = row;
      candidate[t] = pos < N && !suppressed;
    }
    __syncthreads();
    if (tid < 32) {
      uint64_t alive = (uint64_t)__ballot_sync(0xffffffffu, candidate[lane]) |
                       (uint64_t)__ballot_sync(0xffffffffu, candidate[lane + 32]) << 32;
      uint64_t keep = 0;
      if (lane == 0) {
        for (int room = max_out - n_kept; alive && room > 0; --room) {
          const uint64_t bit = alive & (~alive + 1);
          keep |= bit;
          alive &= ~(rows[__ffsll((long long)bit) - 1] | bit);
        }
      }
      keep = __shfl_sync(0xffffffffu, keep, 0);
      for (int c = lane; c < kChunk; c += 32) {
        if (keep >> c & 1) {
          const int slot = n_kept + __popcll(keep & ((1ull << c) - 1));
          const int idx = (int)(uint32_t)keys[base + c];
          kept[slot] = idx;
          io[slot] = idx;
          mo[slot] = true;
        }
      }
      if (lane == 0) n_kept_s = n_kept + __popcll(keep);
    }
    __syncthreads();
    n_kept = n_kept_s;
    // Sorted: an invalid score anywhere in the chunk means its last one is.
    const int last = min(base + kChunk, N) - 1;
    if (!(key_score(keys[last]) > kNeg * 0.5f)) break;
  }
  for (int k = n_kept + tid; k < max_out; k += kThreads) {
    io[k] = 0;
    mo[k] = false;
  }
}

int padded(int64_t N) {
  int n = 64;
  while (n < N) n <<= 1;
  return n;
}

}  // namespace

// Bytes of shared memory one frame of N boxes needs: boxes and kept
// indices, and the sort keys padded to a power of two.
int64_t nms_smem_bytes(int64_t N) { return 20 * N + 8 * (int64_t)padded(N); }

// Bytes of device-memory scratch the device-memory route needs for B frames
// (0 for the shared-memory route): the padded keys and the kept indices.
int64_t nms_scratch_bytes(int64_t B, int64_t N, int64_t max_out,
                          int64_t max_smem) {
  if (nms_smem_bytes(N) <= max_smem) return 0;
  return 8 * B * ((int64_t)padded(N) + (max_out + 1) / 2);
}

// Launches one block per frame on `stream`: boxes (B, N, 4) xyxy float32,
// scores (B, N) float32 -> idx (B, max_out) int32, mask (B, max_out) bool.
// A null `scratch` takes the shared-memory route, else the device-memory
// route with nms_scratch_bytes of scratch.
cudaError_t nms_launch(const float* boxes, const float* scores, int32_t* idx,
                       bool* mask, void* scratch, int B, int N, int max_out,
                       float thr, cudaStream_t st) {
  if (B <= 0 || N <= 0 || max_out <= 0) return cudaErrorInvalidValue;
  if (scratch != nullptr) {
    nms_sorted_kernel<false><<<B, kThreads, 0, st>>>(
        boxes, scores, idx, mask, static_cast<uint64_t*>(scratch), N, padded(N),
        max_out, thr);
    return cudaGetLastError();
  }
  const size_t smem = (size_t)nms_smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      nms_sorted_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  nms_sorted_kernel<true><<<B, kThreads, smem, st>>>(
      boxes, scores, idx, mask, nullptr, N, padded(N), max_out, thr);
  return cudaGetLastError();
}
