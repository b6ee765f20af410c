// Batched k-means assignment + cluster moments for the grouped C step.
//
// Replaces the TPU kernel
//   src/repro/kernels/kmeans/kmeans.py:kmeans_assign_moments_batched
//   (body _batched_kernel).
//
// For a packed group w (I, P) f32 with per-item codebooks (I, K) f32
// (K <= 256; entries at or past an item's live count are +inf):
//   assign[i, p] = argmin_k (w[i, p] - cb[i, k])^2, first index on ties;
//   sums[i, k]   = sum of w[i, p] over p with assign[i, p] == k;
//   counts[i, k] = number of such p (int32: exact beyond 2^24 elements,
//                  where the TPU kernel's f32 counts stop being exact).
//
// Bound on the H100: every element is read once (4 B) and its assignment
// written once (4 B), against ~3K flops of f32 arithmetic on a codebook
// held in shared memory, so for the K <= 16 of the main path the kernel is
// memory-bound (8 B/element over 3.35 TB/s). The design spends nothing
// else on device memory: the codebook is loaded into shared memory once
// per block, the argmin runs in registers, and the moments leave each
// block as one (K,) partial per tile of 4096 elements (2·K·4 B per 4096
// elements, under 1% of the traffic for K <= 16).
//
// Determinism: no float atomics. Each block reduces its tile in a fixed
// order (thread-local sums over its 16 elements, a fixed warp shuffle
// tree, then the 8 warps in order) and writes its partial to scratch; a
// second kernel sums the partials of each (item, cluster) in a fixed
// order. A rerun gives the same bits. The ragged tail of P is masked
// inside the kernel; nothing is padded.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kElems = 16;                  // elements per thread per tile
constexpr int kTile = kThreads * kElems;    // 4096 elements per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 256;

__global__ void __launch_bounds__(kThreads)
assign_partial_kernel(const float* __restrict__ w,
                      const float* __restrict__ codebooks,
                      int64_t p, int k, int64_t n_tiles,
                      int* __restrict__ assign,
                      float* __restrict__ part_sums,
                      int* __restrict__ part_counts) {
  __shared__ float s_cb[kMaxK];
  __shared__ float s_warp_sum[kWarps][kMaxK];
  __shared__ int s_warp_cnt[kWarps][kMaxK];

  const int64_t item = blockIdx.y;
  const int64_t tile = blockIdx.x;
  const int tid = threadIdx.x;
  for (int j = tid; j < k; j += kThreads) s_cb[j] = codebooks[item * k + j];
  __syncthreads();

  const float* wi = w + item * p;
  int* ai = assign + item * p;
  const int64_t base = tile * kTile;

  float vals[kElems];
  int idx[kElems];
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    const int64_t pos = base + (int64_t)e * kThreads + tid;
    vals[e] = 0.f;
    idx[e] = -1;  // masked tail: belongs to no cluster
    if (pos < p) {
      const float x = wi[pos];
      float best = INFINITY;
      int arg = 0;
      for (int j = 0; j < k; ++j) {
        float d = x - s_cb[j];
        d = d * d;
        if (d < best) {  // strict: the first minimum wins, +inf never does
          best = d;
          arg = j;
        }
      }
      ai[pos] = arg;
      vals[e] = x;
      idx[e] = arg;
    }
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int j = 0; j < k; ++j) {
    float s = 0.f;
    int c = 0;
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      if (idx[e] == j) {
        s += vals[e];
        c += 1;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, off);
      c += __shfl_down_sync(0xffffffffu, c, off);
    }
    if (lane == 0) {
      s_warp_sum[warp][j] = s;
      s_warp_cnt[warp][j] = c;
    }
  }
  __syncthreads();

  for (int j = tid; j < k; j += kThreads) {
    float s = 0.f;
    int c = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      s += s_warp_sum[v][j];
      c += s_warp_cnt[v][j];
    }
    const int64_t o = (item * n_tiles + tile) * k + j;
    part_sums[o] = s;
    part_counts[o] = c;
  }
}

// grid (K, I): one block per (cluster, item) sums that pair's per-tile
// partials — strided per thread in tile order, then a fixed tree.
__global__ void __launch_bounds__(kThreads)
reduce_partials_kernel(const float* __restrict__ part_sums,
                       const int* __restrict__ part_counts,
                       int64_t n_tiles, int k,
                       float* __restrict__ sums, int* __restrict__ counts) {
  __shared__ float s_sum[kThreads];
  __shared__ int s_cnt[kThreads];
  const int j = blockIdx.x;
  const int64_t item = blockIdx.y;
  const int tid = threadIdx.x;
  float s = 0.f;
  int c = 0;
  for (int64_t t = tid; t < n_tiles; t += kThreads) {
    const int64_t o = (item * n_tiles + t) * k + j;
    s += part_sums[o];
    c += part_counts[o];
  }
  s_sum[tid] = s;
  s_cnt[tid] = c;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (tid < off) {
      s_sum[tid] += s_sum[tid + off];
      s_cnt[tid] += s_cnt[tid + off];
    }
    __syncthreads();
  }
  if (tid == 0) {
    sums[item * k + j] = s_sum[0];
    counts[item * k + j] = s_cnt[0];
  }
}

}  // namespace

extern "C" {

// `part_sums`/`part_counts` are (I, n_tiles, K) scratch allocated by the
// caller; n_tiles must be ceil(P / 4096), or nothing is launched.
// Launches both kernels on `stream` and returns the cudaError_t of the
// launches (0 on success). Does not synchronise.
int kmeans_assign_moments_batched(const float* w, const float* codebooks,
                                  long long n_items, long long p, int k,
                                  long long n_tiles, int* assign,
                                  float* part_sums, int* part_counts,
                                  float* sums, int* counts, void* stream) {
  if (n_items < 1 || n_items > 65535 || p < 1 || k < 1 || k > kMaxK ||
      n_tiles != (p + kTile - 1) / kTile || n_tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  assign_partial_kernel<<<dim3((unsigned)n_tiles, (unsigned)n_items),
                          kThreads, 0, s>>>(
      w, codebooks, p, k, n_tiles, assign, part_sums, part_counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<dim3((unsigned)k, (unsigned)n_items), kThreads, 0,
                           s>>>(part_sums, part_counts, n_tiles, k, sums,
                                counts);
  return (int)cudaGetLastError();
}

}  // extern "C"
