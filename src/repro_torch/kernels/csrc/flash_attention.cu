// Fused flash-attention forward: causal (+ sliding window), GQA-native.
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py:flash_attention
//   (body _kernel).
//
// For q (B, KV, G, S, D), k and v (B, KV, S, D), all f32 and contiguous:
//   o[b, h, g, i] = sum_j softmax_j(q[b,h,g,i] . k[b,h,j] * scale) v[b,h,j]
// over keys j <= i (and j > i - window when window > 0), scale = 1/sqrt(D).
// The (S, S) score matrix never reaches device memory.
//
// Bound on the H100: the kernel reads q, k, v and writes o once, and does
// about 4·D f32 operations per (query, key) pair it keeps (2·B·H·S²·D for
// a causal S); at the main path's S = 512, D = 96 that is ~64 operations
// per byte moved, so it is bound by f32 operations (67 TFLOP/s without the
// tensor cores), not by the 3.35 TB/s of device memory. The design keeps
// every operand in shared memory and registers and spends device memory
// only on the boundary I/O:
//   * one block per (q tile, kv head, batch) holds all G query heads of
//     its kv head (64 query rows = G heads × 64/G positions), so each K/V
//     tile is read once per group (the GQA sharing of the Pallas
//     BlockSpecs that ignore g);
//   * the Pallas kernel walks kv tiles on a sequential grid axis and
//     carries the running max m and sum l in scratch across grid steps;
//     here a loop over kv tiles runs inside the block, with m and l in
//     shared memory and the output accumulator in registers;
//   * kv tiles wholly above the diagonal, or wholly outside the window,
//     are skipped (their weights are exactly zero);
//   * any S: the ragged tail of queries and keys is masked in the kernel.
// Numerics follow the Pallas kernel: NEG_INF = -1e30, l clamped at 1e-30.
// Shared-memory rows are padded to D + 1 floats so that the column reads
// of the score product fall in distinct banks. The products run on the
// f32 CUDA cores; tensor cores (wgmma, TMA) are later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;      // query rows per block
constexpr int kKv = 64;        // keys per kv tile
constexpr int kPStride = kKv + 1;
constexpr float kNegInf = -1e30f;

template <int D>
constexpr int smem_floats() {
  return kRows * (D + 1) + kKv * (D + 1) + kKv * D + kRows * kPStride +
         3 * kRows;
}

// grid (n_q_tiles, KV, B); bq = query positions per tile (kRows / G)
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int s, int g, int bq, int window, float scale) {
  constexpr int DP = D + 1;
  constexpr int DPT = (D + 15) / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* s_q = smem;                       // [kRows][DP]
  float* s_k = s_q + kRows * DP;           // [kKv][DP]
  float* s_v = s_k + kKv * DP;             // [kKv][D]
  float* s_p = s_v + kKv * D;              // [kRows][kPStride]
  float* s_m = s_p + kRows * kPStride;     // [kRows] running max
  float* s_l = s_m + kRows;                // [kRows] running sum
  float* s_alpha = s_l + kRows;            // [kRows] rescale of this tile

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * bq;
  const int rows = g * bq;                 // live rows of this block
  const int64_t n_kv = gridDim.y;
  const int64_t head0 = ((int64_t)blockIdx.z * n_kv + blockIdx.y) * g;
  const int64_t kv_base = ((int64_t)blockIdx.z * n_kv + blockIdx.y) * s;

  // row r is query head head0 + r / bq at position q0 + r % bq
  for (int e = tid; e < kRows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    float val = 0.f;
    if (r < rows) {
      const int pos = q0 + r % bq;
      if (pos < s) val = q[((head0 + r / bq) * s + pos) * D + d];
    }
    s_q[r * DP + d] = val;
  }
  if (tid < kRows) {
    s_m[tid] = kNegInf;
    s_l[tid] = 0.f;
  }

  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  // kv tiles that hold a key some live query of this block attends to
  const int q_last = min(q0 + bq, s) - 1;
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / kKv;
  const int kt_end = q_last / kKv;
  __syncthreads();

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * kKv;
    for (int e = tid; e < kKv * D; e += kThreads) {
      const int c = e / D, d = e % D;
      const int pos = k0 + c;
      float kval = 0.f, vval = 0.f;
      if (pos < s) {
        const int64_t off = (kv_base + pos) * D + d;
        kval = k[off];
        vval = v[off];
      }
      s_k[c * DP + d] = kval;
      s_v[c * D + d] = vval;
    }
    __syncthreads();

    // scores: thread (ty, tx) owns rows ty + 16i and keys tx + 16j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_q[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = s_k[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r % bq;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        const bool ok = r < rows && kpos < s && kpos <= qpos &&
                        (window <= 0 || kpos > qpos - window);
        s_p[r * kPStride + c] = ok ? sc[i][j] * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: four neighbouring lanes of one warp share a row
    {
      const int r = tid / 4, part = tid % 4;
      float* row = s_p + r * kPStride;
      float mx = kNegInf;
      for (int c = part; c < kKv; c += 4) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = s_m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = part; c < kKv; c += 4) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        s_alpha[r] = alpha;
        s_l[r] = s_l[r] * alpha + sum;
        s_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc·alpha + P V: thread owns rows ty + 16i, columns tx + 16j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = s_alpha[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= al;
    }
#pragma unroll 4
    for (int c = 0; c < kKv; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = s_p[(ty + 16 * i) * kPStride + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = tx + 16 * j;
        if (D % 16 == 0 || d < D) {
          const float vv = s_v[c * D + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites s_k, s_v and s_p
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int pos = q0 + r % bq;
    if (r < rows && pos < s) {
      const float inv_l = 1.f / fmaxf(s_l[r], 1e-30f);
      float* out = o + ((head0 + r / bq) * s + pos) * D;
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = tx + 16 * j;
        if (D % 16 == 0 || d < D) out[d] = acc[i][j] * inv_l;
      }
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   long long b, long long kvh, long long g, long long s,
                   int window, float scale, cudaStream_t stream) {
  constexpr size_t bytes = sizeof(float) * smem_floats<D>();
  // The attribute is per device, so set it on every launch (it is cheap):
  // a once-per-process flag would miss a second card.
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int bq = kRows / (int)g;
  const long long n_q_tiles = (s + bq - 1) / bq;
  if (n_q_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_attention_kernel<D>
      <<<dim3((unsigned)n_q_tiles, (unsigned)kvh, (unsigned)b), kThreads,
         bytes, stream>>>(q, k, v, o, (int)s, (int)g, bq, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, KV, G, S, D), k/v (B, KV, S, D), o like q; all f32, contiguous.
// D in {8, 16, 32, 64, 96, 128}, 1 <= G <= 64, B and KV <= 65535.
// Launches on `stream` and returns the cudaError_t of the launch (0 on
// success). Does not synchronise.
int flash_attention_fwd(const float* q, const float* k, const float* v,
                        float* o, long long b, long long kvh, long long g,
                        long long s, int d, int window, float scale,
                        void* stream) {
  if (b < 1 || b > 65535 || kvh < 1 || kvh > 65535 || g < 1 || g > kRows ||
      s < 1 || s > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8: return (int)launch<8>(q, k, v, o, b, kvh, g, s, window, scale, st);
    case 16: return (int)launch<16>(q, k, v, o, b, kvh, g, s, window, scale, st);
    case 32: return (int)launch<32>(q, k, v, o, b, kvh, g, s, window, scale, st);
    case 64: return (int)launch<64>(q, k, v, o, b, kvh, g, s, window, scale, st);
    case 96: return (int)launch<96>(q, k, v, o, b, kvh, g, s, window, scale, st);
    case 128: return (int)launch<128>(q, k, v, o, b, kvh, g, s, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
