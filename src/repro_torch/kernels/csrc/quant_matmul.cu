// Codebook-dequant GEMMs for compressed serving: y = x @ codebook[idx].
//
// Replaces the TPU kernels
//   src/repro/kernels/quant_matmul/quant_matmul.py:quant_matmul
//     (body _kernel: uint8 indices, K5), and
//   src/repro/kernels/quant_matmul/quant_matmul.py:quant_matmul_packed
//     (body _packed_kernel: two 4-bit indices per byte, K4).
// Both come from the same two kernels (decode and prefill), templated on
// the index width (BITS = 8 or 4).
//
// x (M, K) f32 row-major; w (K, N) uint8 indices (BITS = 8) or (K/2, N)
// packed bytes (BITS = 4: byte (r, n) holds the index of row 2r in its low
// nibble and of row 2r+1 in its high nibble); codebook (C,) f32 with
// C <= 256 (8-bit) or C <= 16 (4-bit); y (M, N) f32. The dense weight
// never exists in device memory: each K tile of indices is read once per
// block, dequantized through a shared-memory lookup table (the Pallas
// kernel's compare-select over the codebook works around the TPU's lack
// of a vector gather; Hopper has one) and consumed from shared memory.
// The 4-bit kernel unpacks both nibbles in the kernel, so x is read as it
// is (the Pallas wrapper splits x into even and odd columns beforehand).
//
// Bound on the H100. Decode is a skinny product (M = 2..8 against a
// 3072 x 8192 weight): the weight's bytes dominate (K·N/2 or K·N) and the
// bound is bytes over 3.35 TB/s, a few microseconds. Prefill (M = 1024)
// does 2·M·K·N f32 operations, bound by the 67 TFLOP/s of the f32 CUDA
// cores. The design picks one of two kernels by M, both templated on the
// index width:
//   * M <= 8 (decode), quant_gemv_kernel: a block owns 32 columns; its
//     256 threads are 4 column groups (8 adjacent columns: one 64-bit
//     load per weight row) x 64 K lanes; every thread issues the loads
//     of 8 of its rows before it uses them (enough bytes in flight to
//     cover the memory latency) and keeps M x 8 sums in registers; the
//     64 lanes' partial sums are then added in a fixed order (a warp
//     shuffle tree, then the warps through shared memory). x (at most 8
//     rows) is read through the L1 cache.
//   * M > 8 (prefill), quant_matmul_kernel: 128 x 128 output tiles of
//     8 x 8 register micro-tiles with an 8-deep K step; the next K
//     tile's global loads are issued into registers before the current
//     tile's products, so they are in flight during the arithmetic.
// Tensor cores (wgmma, TMA) are later work.
//
// Accumulation: the whole K range of an output runs inside one block (no
// split-K across blocks, no atomics), so a rerun gives the same bits;
// partial sums (a K tile, or a K lane) are summed on their own before
// they join, which keeps the rounding error of long K sums down. Ragged
// M, N and K edges are masked in the kernels: out-of-range x reads as 0
// and out-of-range indices as 0, and only in-range outputs are written.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCodes = 256;

// prefill: BM x BN output tiles, BK-deep K steps, TM x TN per thread
constexpr int BM = 128, BN = 128, BK = 8, TM = 8, TN = 8;

template <int BITS>
__global__ void __launch_bounds__(kThreads)
quant_matmul_kernel(const float* __restrict__ x,
                    const uint8_t* __restrict__ w,
                    const float* __restrict__ codebook, int n_codes,
                    float* __restrict__ y, int m, int n, int k) {
  constexpr int kWRowsPerTile = BITS == 4 ? BK / 2 : BK;
  constexpr int kXPerThread = BM * BK / kThreads;
  constexpr int kWPerThread = kWRowsPerTile * BN / kThreads;
  constexpr int kThreadCols = BN / TN;
  constexpr int kThreadRows = BM / TM;
  constexpr int kXPad = 4;   // s_x rows padded against bank conflicts
  static_assert(kThreadRows * kThreadCols == kThreads, "thread grid");
  static_assert(BM * BK % kThreads == 0, "x tile load");
  static_assert(kWRowsPerTile * BN % kThreads == 0, "w tile load");
  static_assert(BITS == 8 || (BITS == 4 && BK % 2 == 0), "4-bit K tile");

  __shared__ float s_cb[kMaxCodes];
  __shared__ float s_x[BK][BM + kXPad];   // x tile, transposed
  __shared__ float s_w[BK][BN];           // dequantized weight tile

  const int tid = threadIdx.x;
  const int tx = tid % kThreadCols;
  const int ty = tid / kThreadCols;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int w_rows = BITS == 4 ? k / 2 : k;
  for (int j = tid; j < kMaxCodes; j += kThreads)
    s_cb[j] = j < n_codes ? codebook[j] : 0.f;

  float x_reg[kXPerThread];
  uint8_t w_reg[kWPerThread];
  auto load_tile = [&](int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < kXPerThread; ++i) {
      const int e = i * kThreads + tid;
      const int gm = m0 + e / BK, gk = k0 + e % BK;
      x_reg[i] = (gm < m && gk < k) ? x[(int64_t)gm * k + gk] : 0.f;
    }
    const int r0 = BITS == 4 ? k0 / 2 : k0;
#pragma unroll
    for (int i = 0; i < kWPerThread; ++i) {
      const int e = i * kThreads + tid;
      const int gr = r0 + e / BN, gn = n0 + e % BN;
      w_reg[i] = (gr < w_rows && gn < n) ? w[(int64_t)gr * n + gn] : 0;
    }
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < kXPerThread; ++i) {
      const int e = i * kThreads + tid;
      s_x[e % BK][e / BK] = x_reg[i];
    }
#pragma unroll
    for (int i = 0; i < kWPerThread; ++i) {
      const int e = i * kThreads + tid;
      const int r = e / BN, c = e % BN;
      const uint8_t b = w_reg[i];
      if constexpr (BITS == 8) {
        s_w[r][c] = s_cb[b];
      } else {
        s_w[2 * r][c] = s_cb[b & 0x0F];
        s_w[2 * r + 1][c] = s_cb[b >> 4];
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int n_kt = (k + BK - 1) / BK;
  load_tile(0);
  __syncthreads();  // the codebook table is in place
  for (int kt = 0; kt < n_kt; ++kt) {
    store_tile();
    __syncthreads();
    if (kt + 1 < n_kt) load_tile(kt + 1);   // in flight during the products
    float part[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = s_x[kk][ty + i * kThreadRows];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = s_w[kk][tx + j * kThreadCols];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];
    __syncthreads();  // the next store_tile overwrites s_x and s_w
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * kThreadRows;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * kThreadCols;
      if (gn < n) y[(int64_t)gm * n + gn] = acc[i][j];
    }
  }
}

// decode: a block owns kGemvCols columns; a thread owns 8 adjacent ones
// (one 64-bit load per weight row) and every kGemvLanes-th row of K
constexpr int kGemvGroups = 4;                   // column groups of 8
constexpr int kGemvCols = 8 * kGemvGroups;       // 32 columns per block
constexpr int kGemvLanes = kThreads / kGemvGroups;
constexpr int kGemvUnroll = 8;                   // row loads in flight
constexpr int kGemvMaxM = 8;
constexpr int kWarps = kThreads / 32;

template <int BITS>
__global__ void __launch_bounds__(kThreads)
quant_gemv_kernel(const float* __restrict__ x,
                  const uint8_t* __restrict__ w,
                  const float* __restrict__ codebook, int n_codes,
                  float* __restrict__ y, int m, int n, int k,
                  bool aligned) {
  __shared__ float s_cb[kMaxCodes];
  __shared__ float s_part[kWarps][kGemvMaxM][kGemvCols];

  const int tid = threadIdx.x;
  const int grp = tid % kGemvGroups;
  const int lane = tid / kGemvGroups;
  const int col = blockIdx.x * kGemvCols + 8 * grp;
  const int w_rows = BITS == 4 ? k / 2 : k;
  for (int j = tid; j < kMaxCodes; j += kThreads)
    s_cb[j] = j < n_codes ? codebook[j] : 0.f;
  __syncthreads();

  float acc[kGemvMaxM][8];
#pragma unroll
  for (int i = 0; i < kGemvMaxM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // 64-bit loads when the eight columns are in range and aligned
  const bool vec = aligned && col + 7 < n;
  for (int r0 = lane; r0 < w_rows; r0 += kGemvLanes * kGemvUnroll) {
    uint2 v[kGemvUnroll];
#pragma unroll
    for (int u = 0; u < kGemvUnroll; ++u) {
      const int r = r0 + u * kGemvLanes;
      v[u] = make_uint2(0u, 0u);
      if (r < w_rows) {
        const uint8_t* row = w + (int64_t)r * n + col;
        if (vec) {
          v[u] = __ldg(reinterpret_cast<const uint2*>(row));
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (col + j < n) {
              if (j < 4) v[u].x |= (uint32_t)row[j] << (8 * j);
              else v[u].y |= (uint32_t)row[j] << (8 * (j - 4));
            }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kGemvUnroll; ++u) {
      const int r = r0 + u * kGemvLanes;
      if (r >= w_rows) break;
      uint8_t b[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = (v[u].x >> (8 * j)) & 0xFF;
        b[j + 4] = (v[u].y >> (8 * j)) & 0xFF;
      }
      if constexpr (BITS == 8) {
        float wv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) wv[j] = s_cb[b[j]];
#pragma unroll
        for (int i = 0; i < kGemvMaxM; ++i) {
          if (i < m) {
            const float xv = __ldg(x + (int64_t)i * k + r);
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
          }
        }
      } else {
        float lo[8], hi[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          lo[j] = s_cb[b[j] & 0x0F];
          hi[j] = s_cb[b[j] >> 4];
        }
#pragma unroll
        for (int i = 0; i < kGemvMaxM; ++i) {
          if (i < m) {
            const float x0 = __ldg(x + (int64_t)i * k + 2 * r);
            const float x1 = __ldg(x + (int64_t)i * k + 2 * r + 1);
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(x1, hi[j], fmaf(x0, lo[j], acc[i][j]));
          }
        }
      }
    }
  }

  // the 8 lanes of a warp that share a column group: a fixed shuffle tree;
  // then the warps in order through shared memory
  const int warp = tid / 32;
#pragma unroll
  for (int i = 0; i < kGemvMaxM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float a = acc[i][j];
      a += __shfl_xor_sync(0xffffffffu, a, 4);
      a += __shfl_xor_sync(0xffffffffu, a, 8);
      a += __shfl_xor_sync(0xffffffffu, a, 16);
      acc[i][j] = a;
    }
  if ((tid & 31) < kGemvGroups) {
#pragma unroll
    for (int i = 0; i < kGemvMaxM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s_part[warp][i][8 * grp + j] = acc[i][j];
  }
  __syncthreads();
  // one output per thread: (row i, column c) summed over the warps in order
  const int i = tid / kGemvCols, c = tid % kGemvCols;
  const int gn = blockIdx.x * kGemvCols + c;
  if (i < m && gn < n) {
    float sum = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) sum += s_part[wp][i][c];
    y[(int64_t)i * n + gn] = sum;
  }
}
static_assert(kGemvMaxM * kGemvCols == kThreads, "one output per thread");

template <int BITS>
int launch(const float* x, const uint8_t* w, const float* cb, int n_codes,
           float* y, long long m, long long n, long long k, void* stream) {
  const int max_codes = BITS == 4 ? 16 : kMaxCodes;
  if (m < 1 || n < 1 || k < 1 || m > 0x7fffffffLL || n > 0x7fffffffLL ||
      k > 0x7fffffffLL || n_codes < 1 || n_codes > max_codes ||
      (BITS == 4 && k % 2 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= kGemvMaxM) {
    const bool aligned =
        n % 8 == 0 && (reinterpret_cast<uintptr_t>(w) & 7) == 0;
    const long long blocks = (n + kGemvCols - 1) / kGemvCols;
    quant_gemv_kernel<BITS><<<(unsigned)blocks, kThreads, 0, st>>>(
        x, w, cb, n_codes, y, (int)m, (int)n, (int)k, aligned);
    return (int)cudaGetLastError();
  }
  const long long grid_y = (m + BM - 1) / BM;
  if (grid_y > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + BN - 1) / BN), (unsigned)grid_y);
  quant_matmul_kernel<BITS><<<grid, kThreads, 0, st>>>(
      x, w, cb, n_codes, y, (int)m, (int)n, (int)k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K5: idx (K, N) uint8, 1 <= C <= 256. Launches on `stream` and returns
// the cudaError_t of the launch (0 on success). Does not synchronise.
int quant_matmul_u8(const float* x, const uint8_t* idx, const float* codebook,
                    int n_codes, float* y, long long m, long long n,
                    long long k, void* stream) {
  return launch<8>(x, idx, codebook, n_codes, y, m, n, k, stream);
}

// K4: packed (K/2, N) uint8 with K even (an odd-K weight is packed with a
// zero-index pad row and x carries a zero column), 1 <= C <= 16.
int quant_matmul_packed4(const float* x, const uint8_t* packed,
                         const float* codebook, int n_codes, float* y,
                         long long m, long long n, long long k,
                         void* stream) {
  return launch<4>(x, packed, codebook, n_codes, y, m, n, k, stream);
}

}  // extern "C"
