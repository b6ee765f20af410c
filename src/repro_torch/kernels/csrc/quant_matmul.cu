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
// C <= 256 (8-bit) or C <= 16 (4-bit), every index < C; y (M, N) f32. The
// dense weight never exists in device memory: index tiles are staged in
// shared memory and dequantized through a shared-memory table (the Pallas
// kernel's compare-select over the codebook works around the TPU's lack
// of a vector gather; Hopper has one). Both nibbles are unpacked in the
// kernel, so x is read as it is (the Pallas wrapper splits x into even
// and odd columns beforehand).
//
// Two regimes, two bounds on the H100 (SXM, 700 W):
//   * Decode, M <= kGemvMaxM (M = 2 in Server, 8 in the engine's slots):
//     the weight's bytes (K·N or K·N/2) dominate, so the bound is bytes
//     over 3.35 TB/s, 2.8 us for a 3072 x 3072 u8 weight.
//     quant_gemv_kernel<BITS, M> is templated on M, so its M x 4 sums per
//     thread scale with M, on the f32 CUDA cores. A block owns 64 columns
//     and one K slice of at most 512 weight rows: split-K across blocks,
//     about three blocks an SM in all, so that every SM has work at N =
//     3072 and all blocks are resident at once (but for the 4-bit M > 4
//     instances, which take two blocks' registers). It issues its whole
//     slice of index bytes at the start, one cp.async group of 64 rows at
//     a time, 16 bytes a thread, neighbouring threads on neighbouring
//     columns (64-byte row segments: whole sectors), so each SM has ~70 KB
//     in flight, and computes each group as it lands. Its x slice (M rows)
//     sits in shared memory and is read as a broadcast, 4 rows at a time
//     (4-bit: one packed row's two columns as a float2). The codebook
//     table is replicated per bank (s_cb[c·32 + lane]), so random indices
//     never conflict, and a lookup's address takes two integer operations
//     (8-bit: byte_perm + lea; 4-bit: the table at a 2 KB boundary, shift
//     + and-or). The slices' partial sums go to a workspace; the block
//     that takes a column tile's last ticket sums them in slice order,
//     writes y and resets the tile's counter: no float atomics, the same
//     bits on every rerun, one launch. What the card shows it costs: the
//     table lookups (one per weight, an LDS each) and the ticket's three
//     L2 round trips, beside the loads themselves.
//   * Prefill, M > kGemvMaxM: 2·M·K·N operations dominate.
//     quant_mma_kernel<BITS> runs them on the tensor cores as TF32
//     mma.sync.m16n8k8 with the 3-pass split (v = hi + lo; lo·hi + hi·lo,
//     then hi·hi), because one TF32 pass keeps ~3 digits, far short of the
//     reference's rtol 1e-5 / atol 1e-4; so the bound is 3 · 2·M·K·N at
//     495 TFLOP/s (TF32 dense). The weight side needs no split arithmetic:
//     each block holds the codebook as a table of (tf32(c), tf32(c -
//     tf32(c))) pairs, both rounded to nearest, replicated 16 times
//     against bank conflicts, and the B fragments are read from it. Only x
//     is split, per warp from registers (splitting once per block into
//     shared memory measured slower, as in K6): hi = x truncated to TF32
//     (a mask), lo = x - hi as it is, which the tensor cores read
//     truncated. The tensor cores round their sums toward zero, a bias
//     that grows with K in a long accumulator (past the tolerance at K =
//     8192), so each group of 4 k steps is summed from 0 and then added
//     to the f32 sums to nearest; those sums take 64 registers a thread
//     beside the 64 of the accumulator, so one block runs on an SM
//     (measured faster than two blocks of 2-step groups). 128 x 128 x 32
//     block tiles, 8 warps of 64 x 32; x and index tiles come in with
//     cp.async into a 3-stage ring; rows are padded so that every
//     fragment read falls in distinct banks. Within an 8-deep k step the
//     mma's k index t stands for row 2t and t + 4 for row 2t + 1, so a
//     thread's two A values are one float2 and its two B rows are the two
//     nibbles of one byte (4-bit) or two adjacent rows (8-bit); within a
//     warp's 32 columns the mma's n index g of n tile j stands for column
//     4g + j, so a thread reads its four n tiles' indices as one 32-bit
//     word and writes 8 adjacent outputs. Blocks are ordered with the M
//     tiles fastest, so neighbours share a weight column tile in L2. The
//     whole K range of an output stays in one block, summed in a fixed
//     order.
// Ragged M, N and K are masked in the kernels: out-of-range x reads as 0,
// out-of-range indices as 0, and only in-range outputs are written.
// 16-byte loads only where the operands are aligned (weight base and N
// for the indices, x base and K for x); otherwise the tiles are loaded
// element by element into the same layout.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(live ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool live) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(live ? 4 : 0));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------- decode
constexpr int kGemvMaxM = 8;
constexpr int kGemvCols = 64;        // columns per block
constexpr int kGemvColGroups = 16;   // 4 columns per thread when computing
constexpr int kGemvChunk = 64;       // rows per cp.async group: 1 copy a thread
constexpr int kGemvWStride = 80;     // bytes a staged row: reads 4 rows apart
                                     // fall 16 banks apart
constexpr int kGemvMaxChunks = 8;    // so at most 512 rows a slice

// bytes of dynamic shared memory: the replicated codebook table, the
// index slice (reused for the warps' partial sums), the x slice and the
// codebook as given
__host__ __device__ inline int gemv_w_bytes(int chunks, int m) {
  const int w = chunks * kGemvChunk * kGemvWStride;
  const int p = kWarps * m * kGemvCols * 4;
  return w > p ? w : p;
}
__host__ __device__ inline int gemv_smem_bytes(int chunks, int m, int xw,
                                               int n_codes) {
  // + 2 KB: room to align the 4-bit table to 2 KB; + 1 KB: the codebook
  return gemv_w_bytes(chunks, m) + n_codes * 32 * 4 +
         m * chunks * kGemvChunk * xw * 4 + 2048 + 1024;
}

// ((v >> s) & 15) << 7, as one shift and one mask
__device__ __forceinline__ uint32_t nib7(uint32_t v, int s) {
  return (s >= 7 ? v >> (s - 7) : v << (7 - s)) & 0x780u;
}

__device__ __forceinline__ float2 lds2(uint32_t addr) {
  float2 v;
  asm("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

// a table read; not volatile, so that it schedules freely (its address
// comes from index bytes read after the chunk's barrier)
__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void cp_async_wait_dyn(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    default: cp_async_wait<8>(); break;
  }
}

// the blocks an SM that the register budget leaves room for (64
// registers a thread at 4, 80 at 3, 128 at 2). At M > 4 the 4-bit loop
// takes 108 (two blocks resident), which measured faster than capped at
// 80; the 8-bit loop keeps the 80-register cap with one register spilled
// outside the inner loop, which measured faster than 96 registers and
// two blocks, or than a two-row loop (which spills too)
template <int BITS, int MT>
constexpr int gemv_min_blocks() {
  return MT <= 4 ? 4 : BITS == 4 ? 2 : 3;
}

// grid (slices, column tiles): block (s, t) sums rows [s·slice_rows,
// (s+1)·slice_rows) of column tile t
template <int BITS, int MT>
__global__ void __launch_bounds__(kThreads, gemv_min_blocks<BITS, MT>())
quant_gemv_kernel(const float* __restrict__ x,
                  const uint8_t* __restrict__ w,
                  const float* __restrict__ codebook, int n_codes,
                  float* __restrict__ y, int n, int k, int slice_rows,
                  bool vec, bool vec_x, float* __restrict__ ws,
                  int* __restrict__ counters) {
  constexpr int XW = BITS == 4 ? 2 : 1;   // x columns per weight row
  const int chunks = (slice_rows + kGemvChunk - 1) / kGemvChunk;
  const int xs = chunks * kGemvChunk * XW;          // row stride of s_x
  extern __shared__ float4 smem4[];
  // the codebook table first: replicated per bank, s_cb[c·32 + lane]; for
  // 4-bit at a 2 KB boundary of the shared window, so that a lookup's
  // address is ((nibble << 7) | lane base), one shift and one LOP3
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem4));
  const uint32_t cb_at = BITS == 4 ? (base + 2047u) & ~2047u : base;
  float* s_cb = reinterpret_cast<float*>(
      reinterpret_cast<uint8_t*>(smem4) + (cb_at - base));
  uint8_t* s_w = reinterpret_cast<uint8_t*>(s_cb + n_codes * 32);
  float* s_x = reinterpret_cast<float*>(s_w + gemv_w_bytes(chunks, MT));
  float* s_raw = s_x + MT * xs;
  float* s_part = reinterpret_cast<float*>(s_w);
  __shared__ int s_ticket;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slice = blockIdx.x, n_slices = gridDim.x, tile = blockIdx.y;
  const int rows = BITS == 4 ? k / 2 : k;
  const int r0 = slice * slice_rows;
  const int nr = max(min(slice_rows, rows - r0), 0);
  const int n_chunks = (nr + kGemvChunk - 1) / kGemvChunk;
  const int col0 = tile * kGemvCols;

  // group 0: the codebook and the x slice (M rows; past the slice, 0)
  if (tid < n_codes) cp_async4(s_raw + tid, codebook + tid, true);
  const int xw = nr * XW;
  const float* xg = x + (int64_t)r0 * XW;
  const int xn = n_chunks * kGemvChunk * XW;
  if (vec_x) {
    for (int e = tid; e < MT * (xn / 4); e += kThreads) {
      const int i = e / (xn / 4), c = (e % (xn / 4)) * 4;
      const int live = min(max(xw - c, 0), 4);
      const uint32_t d =
          static_cast<uint32_t>(__cvta_generic_to_shared(s_x + i * xs + c));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                   "l"(live ? xg + (int64_t)i * k + c : x), "r"(4 * live));
    }
  } else {
    for (int e = tid; e < MT * xn; e += kThreads) {
      const int i = e / xn, c = e % xn;
      cp_async4(s_x + i * xs + c, c < xw ? xg + (int64_t)i * k + c : x,
                c < xw);
    }
  }
  cp_async_commit();
  // then the slice of index bytes, one group of 64 rows at a time (rows
  // past the slice read as index 0 and meet x = 0)
  {
    const int c = (tid & 3) * 16;
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int r = ch * kGemvChunk + (tid >> 2);
      const uint8_t* src = w + (int64_t)(r0 + r) * n + col0 + c;
      uint8_t* dst = s_w + r * kGemvWStride + c;
      if (vec) {
        const bool live = r < nr && col0 + c < n;
        cp_async16(dst, live ? src : w, live);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          dst[j] = r < nr && col0 + c + j < n ? src[j] : 0;
      }
      cp_async_commit();
    }
  }
  cp_async_wait_dyn(n_chunks);   // group 0 has landed
  __syncthreads();
  for (int e = tid; e < n_codes * 32; e += kThreads) s_cb[e] = s_raw[e >> 5];

  // each thread: 4 adjacent columns × 4 adjacent rows of every chunk
  const int cgp = tid % kGemvColGroups, rl = tid / kGemvColGroups;
  const uint32_t cb_lane = cb_at + 4u * lane;   // entry c at + 128·c
  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait_dyn(n_chunks - 1 - ch);   // chunk ch has landed
    __syncthreads();
    const int row = ch * kGemvChunk + 4 * rl;
    const uint8_t* wp = s_w + row * kGemvWStride + 4 * cgp;
    if constexpr (BITS == 8) {
      float wv[4][4];   // [row][column]
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t v =
            *reinterpret_cast<const uint32_t*>(wp + q * kGemvWStride);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wv[q][j] = lds(cb_lane + (__byte_perm(v, 0, 0x4440 + j) << 7));
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float4 xv =
            *reinterpret_cast<const float4*>(s_x + i * xs + row);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(xv.w, wv[3][j], fmaf(xv.z, wv[2][j],
                      fmaf(xv.y, wv[1][j], fmaf(xv.x, wv[0][j], acc[i][j]))));
      }
    } else if constexpr (MT > 4) {
      // two packed rows (K rows 2r .. 2r + 3) at a time, x as one float4
      // (fewer x reads; at M <= 4 the single rows below measured faster)
#pragma unroll
      for (int q = 0; q < 4; q += 2) {
        float wv[4][4];   // [K row][column]
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t v = *reinterpret_cast<const uint32_t*>(
              wp + (q + h) * kGemvWStride);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            // nibble (v >> s) & 15, placed at bits 7..10
            wv[2 * h][j] = lds(nib7(v, 8 * j) | cb_lane);
            wv[2 * h + 1][j] = lds(nib7(v, 8 * j + 4) | cb_lane);
          }
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float4 xv = *reinterpret_cast<const float4*>(
              s_x + i * xs + 2 * (row + q));
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(xv.w, wv[3][j], fmaf(xv.z, wv[2][j],
                        fmaf(xv.y, wv[1][j], fmaf(xv.x, wv[0][j], acc[i][j]))));
        }
      }
    } else {
      // one packed row (K rows 2r, 2r + 1) at a time
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t v =
            *reinterpret_cast<const uint32_t*>(wp + q * kGemvWStride);
        float lo[4], hi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // nibble (v >> s) & 15, placed at bits 7..10
          lo[j] = lds(nib7(v, 8 * j) | cb_lane);
          hi[j] = lds(nib7(v, 8 * j + 4) | cb_lane);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float2 xv = *reinterpret_cast<const float2*>(
              s_x + i * xs + 2 * (row + q));
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(xv.y, hi[j], fmaf(xv.x, lo[j], acc[i][j]));
        }
      }
    }
  }

  cp_async_wait<0>();   // a block past the last row has waited for nothing

  // the two row lanes of a warp, then the warps in order
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], 16);
  __syncthreads();   // every thread is done with s_w, which s_part reuses
  if (lane < kGemvColGroups) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s_part[(warp * MT + i) * kGemvCols + 4 * cgp + j] = acc[i][j];
  }
  __syncthreads();
  for (int o = tid; o < MT * kGemvCols; o += kThreads) {
    const int i = o / kGemvCols, gn = col0 + o % kGemvCols;
    if (gn >= n) continue;
    float sum = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) sum += s_part[wp * MT * kGemvCols + o];
    if (n_slices == 1) y[(int64_t)i * n + gn] = sum;
    else ws[((int64_t)slice * MT + i) * n + gn] = sum;
  }
  if (n_slices == 1) return;

  // split-K: the block that takes the tile's last ticket sums the slices
  // in slice order, writes y and leaves the counter at 0
  // the block's ws stores, then the ticket: a gpu-scope acq_rel atomic
  // that releases them (the barrier orders every thread's stores before
  // it) and, in the last block, acquires the other blocks'
  __syncthreads();
  if (tid == 0) {
    int t;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(t) : "l"(counters + tile) : "memory");
    s_ticket = t;
  }
  __syncthreads();
  if (s_ticket != n_slices - 1) return;
  for (int o = tid; o < MT * kGemvCols; o += kThreads) {
    const int i = o / kGemvCols, gn = col0 + o % kGemvCols;
    if (gn >= n) continue;
    const float* p = ws + (int64_t)i * n + gn;
    const int64_t stride = (int64_t)MT * n;
    float sum = 0.f;
    for (int s0 = 0; s0 < n_slices; s0 += 8) {
      float v[8];                 // eight loads in flight, then the sums
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = s0 + u < n_slices ? __ldcg(p + (s0 + u) * stride) : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (s0 + u < n_slices) sum += v[u];
    }
    y[(int64_t)i * n + gn] = sum;
  }
  if (tid == 0) counters[tile] = 0;
}

// --------------------------------------------------------------- prefill
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kXStride = kBK + 8;   // floats: float2 A reads conflict-free
constexpr int kStages = 3;          // the cp.async ring
// k steps (of 8) summed into one partial before it joins the f32 sums
constexpr int kPartial = 4;
static_assert(kBK / 8 % kPartial == 0, "partials tile the k tile");

template <int BITS>
struct MmaTile {
  static constexpr int kWRows = BITS == 4 ? kBK / 2 : kBK;  // index rows
  // bytes; 36 or 40 words, so that a warp's index words hit 32 banks
  static constexpr int kWStride = BITS == 4 ? kBN + 32 : kBN + 16;
  static constexpr int kXFloats = kBM * kXStride;
  static constexpr int kWBytes = kWRows * kWStride;
  // + 2 KB: room to align the 4-bit table to 2 KB
  static constexpr int bytes(int n_codes) {
    return kStages * (kXFloats * 4 + kWBytes) + n_codes * 16 * 8 + 2048;
  }
};

// v rounded to TF32, to nearest with ties away from zero (cvt.rna's
// result, with an add and a mask on the bits)
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// the codebook's halves, once per block: both rounded to nearest
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// x's halves, per use: hi = v truncated to TF32 (a mask), lo = v - hi
// exactly; the tensor cores read lo's top 19 bits, which drops at most
// 2^-20·|v|, the order of lo·lo (left out) and of the rounded split
__device__ __forceinline__ void split_x(float v, uint32_t& hi,
                                        uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = a·b, the sums started from 0
__device__ __forceinline__ void mma0(float (&c)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// one block an SM: the partials' 64 registers sit beside the
// accumulator's 64
template <int BITS>
__global__ void __launch_bounds__(kThreads, 1)
quant_mma_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w,
                 const float* __restrict__ codebook, int n_codes,
                 float* __restrict__ y, int m, int n, int k, int m_tiles,
                 bool vec_x, bool vec_w, bool vec_y) {
  using T = MmaTile<BITS>;
  extern __shared__ float4 smem4[];
  float* s_x = reinterpret_cast<float*>(smem4);
  uint8_t* s_w = reinterpret_cast<uint8_t*>(s_x + kStages * T::kXFloats);
  // the (hi, lo) table: entry c, copy r at byte 128·c + 8·r; for 4-bit at
  // a 2 KB boundary of the shared window, so that a lookup's address is
  // ((nibble << 7) | copy base), one shift and one LOP3
  const uint32_t tab0 = static_cast<uint32_t>(
      __cvta_generic_to_shared(s_w + kStages * T::kWBytes));
  const uint32_t cb_at = BITS == 4 ? (tab0 + 2047u) & ~2047u : tab0;
  float2* s_cb = reinterpret_cast<float2*>(
      s_w + kStages * T::kWBytes + (cb_at - tab0));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;     // 2 x 4 warps of 64 x 32
  const int m0 = (blockIdx.x % m_tiles) * kBM;
  const int n0 = (blockIdx.x / m_tiles) * kBN;
  const int rows = BITS == 4 ? k / 2 : k;

  // (hi, lo) of every codebook entry, 16 copies: lane l reads copy l % 16
  for (int e = tid; e < n_codes * 16; e += kThreads) {
    uint32_t hi, lo;
    split(__ldg(codebook + (e >> 4)), hi, lo);
    s_cb[e] = make_float2(__uint_as_float(hi), __uint_as_float(lo));
  }

  // a thread's x chunks of a tile: e = tid + i·256, row e / 8, column
  // (e % 8)·4, the same in load and split
  auto load = [&](int kt, int st) {
    const int k0 = kt * kBK;
    float* sx = s_x + st * T::kXFloats;
    for (int e = tid; e < kBM * (kBK / 4); e += kThreads) {
      const int r = e / (kBK / 4), c = (e % (kBK / 4)) * 4;
      const int gm = m0 + r, gk = k0 + c;
      const float* src = x + (int64_t)gm * k + gk;
      if (vec_x) {
        const bool live = gm < m && gk < k;
        cp_async16(sx + r * kXStride + c, live ? src : x, live);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sx[r * kXStride + c + j] = gm < m && gk + j < k ? src[j] : 0.f;
      }
    }
    uint8_t* sw = s_w + st * T::kWBytes;
    const int wr0 = BITS == 4 ? k0 / 2 : k0;
    for (int e = tid; e < T::kWRows * (kBN / 16); e += kThreads) {
      const int r = e / (kBN / 16), c = (e % (kBN / 16)) * 16;
      const int gr = wr0 + r, gn = n0 + c;
      const uint8_t* src = w + (int64_t)gr * n + gn;
      if (vec_w) {
        const bool live = gr < rows && gn < n;
        cp_async16(sw + r * T::kWStride + c, live ? src : w, live);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          sw[r * T::kWStride + c + j] = gr < rows && gn + j < n ? src[j] : 0;
      }
    }
  };
  float acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

  const int n_kt = (k + kBK - 1) / kBK;
  load(0, 0);
  cp_async_commit();
  if (n_kt > 1) load(1, 1);
  cp_async_commit();
  const uint32_t cb_lane = cb_at + 8u * (lane & 15);   // entry c at + 128·c
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kStages;
    cp_async_wait<1>();      // tile kt has landed (this thread's part)
    __syncthreads();         // ... every thread's; stage (kt+2)%3 is free
    if (kt + 2 < n_kt) load(kt + 2, (kt + 2) % kStages);
    cp_async_commit();
    const float* sx = s_x + st * T::kXFloats + (wm * 64 + gid) * kXStride +
                      2 * tig;
    const uint8_t* sw = s_w + st * T::kWBytes + wn * 32 + 4 * gid;
#pragma unroll
    for (int k0 = 0; k0 < kBK / 8; k0 += kPartial) {
      // B of k steps k0 .. k0 + kPartial - 1: rows 2·tig and 2·tig + 1 of
      // each, n tiles j = 0..3
      uint32_t bh[kPartial][4][2], bl[kPartial][4][2];
#pragma unroll
      for (int u = 0; u < kPartial; ++u) {
        const int kk = k0 + u;
        if constexpr (BITS == 8) {
          const uint32_t v0 = *reinterpret_cast<const uint32_t*>(
              sw + (kk * 8 + 2 * tig) * T::kWStride);
          const uint32_t v1 = *reinterpret_cast<const uint32_t*>(
              sw + (kk * 8 + 2 * tig + 1) * T::kWStride);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 t0 =
                lds2(cb_lane + (__byte_perm(v0, 0, 0x4440 + j) << 7));
            const float2 t1 =
                lds2(cb_lane + (__byte_perm(v1, 0, 0x4440 + j) << 7));
            bh[u][j][0] = __float_as_uint(t0.x);
            bl[u][j][0] = __float_as_uint(t0.y);
            bh[u][j][1] = __float_as_uint(t1.x);
            bl[u][j][1] = __float_as_uint(t1.y);
          }
        } else {
          const uint32_t v = *reinterpret_cast<const uint32_t*>(
              sw + (kk * 4 + tig) * T::kWStride);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 t0 = lds2(nib7(v, 8 * j) | cb_lane);
            const float2 t1 = lds2(nib7(v, 8 * j + 4) | cb_lane);
            bh[u][j][0] = __float_as_uint(t0.x);
            bl[u][j][0] = __float_as_uint(t0.y);
            bh[u][j][1] = __float_as_uint(t1.x);
            bl[u][j][1] = __float_as_uint(t1.y);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t ah[kPartial][4], al[kPartial][4];
#pragma unroll
        for (int u = 0; u < kPartial; ++u) {
          const float* xa = sx + mt * 16 * kXStride + (k0 + u) * 8;
          const float2 a02 = *reinterpret_cast<const float2*>(xa);
          const float2 a13 =
              *reinterpret_cast<const float2*>(xa + 8 * kXStride);
          split_x(a02.x, ah[u][0], al[u][0]);
          split_x(a13.x, ah[u][1], al[u][1]);
          split_x(a02.y, ah[u][2], al[u][2]);
          split_x(a13.y, ah[u][3], al[u][3]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // the tensor cores round their sums toward zero: summed from 0
          // over kPartial k steps and added here to nearest, that bias
          // stays at the scale of those steps instead of growing with K
          float p[4];
#pragma unroll
          for (int u = 0; u < kPartial; ++u) {
            if (u == 0) mma0(p, al[u], bh[u][j][0], bh[u][j][1]);
            else mma(p, al[u], bh[u][j][0], bh[u][j][1]);
            mma(p, ah[u], bl[u][j][0], bl[u][j][1]);
            mma(p, ah[u], bh[u][j][0], bh[u][j][1]);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][j][q] += p[q];
        }
      }
    }
  }

  // row gid (+8) of m tile mt holds columns 8·tig + {0..3} in acc[mt][j][0]
  // (resp. [2]) and 8·tig + 4 + {0..3} in acc[mt][j][1] (resp. [3])
  const int col = n0 + wn * 32 + 8 * tig;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + mt * 16 + gid + 8 * h;
      if (row >= m) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[mt][j][2 * h];
        v[4 + j] = acc[mt][j][2 * h + 1];
      }
      float* out = y + (int64_t)row * n + col;
      if (vec_y && col + 7 < n) {
        reinterpret_cast<float4*>(out)[0] = make_float4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<float4*>(out)[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (col + q < n) out[q] = v[q];
      }
    }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int BITS, int MT>
cudaError_t launch_gemv(const float* x, const uint8_t* w, const float* cb,
                        int n_codes, float* y, int n, int k, int slices,
                        float* ws, int* counters, cudaStream_t st) {
  constexpr int XW = BITS == 4 ? 2 : 1;
  const int rows = BITS == 4 ? k / 2 : k;
  const long long n_tiles = (n + kGemvCols - 1) / kGemvCols;
  if (slices < 1 || slices > 65535 || n_tiles > 65535 ||
      (slices > 1 && (ws == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  // slices start on 16-row boundaries (16-byte x copies), at most 512
  // rows each
  const int slice_rows = ((rows + slices - 1) / slices + 15) / 16 * 16;
  if (slice_rows > kGemvMaxChunks * kGemvChunk) return cudaErrorInvalidValue;
  const int chunks = (slice_rows + kGemvChunk - 1) / kGemvChunk;
  const int bytes = gemv_smem_bytes(chunks, MT, XW, n_codes);
  if (bytes + 1024 > 48 * 1024) {   // static shared memory counts too
    const cudaError_t err = cudaFuncSetAttribute(
        quant_gemv_kernel<BITS, MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  quant_gemv_kernel<BITS, MT>
      <<<dim3((unsigned)slices, (unsigned)n_tiles), kThreads, bytes, st>>>(
          x, w, cb, n_codes, y, n, k, slice_rows,
          aligned16(w) && n % 16 == 0, aligned16(x) && k % 4 == 0, ws,
          counters);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_mma(const float* x, const uint8_t* w, const float* cb,
                       int n_codes, float* y, int m, int n, int k,
                       cudaStream_t st) {
  const int bytes = MmaTile<BITS>::bytes(n_codes);
  // the attribute is per device, so it is set on every launch (cheap
  // beside a prefill product)
  const cudaError_t err = cudaFuncSetAttribute(
      quant_mma_kernel<BITS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const long long m_tiles = (m + kBM - 1) / kBM;
  const long long blocks = m_tiles * ((n + kBN - 1) / kBN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  quant_mma_kernel<BITS><<<(unsigned)blocks, kThreads, bytes, st>>>(
      x, w, cb, n_codes, y, m, n, k, (int)m_tiles,
      aligned16(x) && k % 4 == 0, aligned16(w) && n % 16 == 0,
      aligned16(y) && n % 4 == 0);
  return cudaGetLastError();
}

template <int BITS>
int launch(const float* x, const uint8_t* w, const float* cb, int n_codes,
           float* y, long long m, long long n, long long k, int slices,
           float* ws, int* counters, void* stream) {
  const int max_codes = BITS == 4 ? 16 : 256;
  if (m < 1 || n < 1 || k < 1 || m > 0x7fffffffLL || n > 0x7fffffffLL ||
      k > 0x7fffffffLL || n_codes < 1 || n_codes > max_codes ||
      (BITS == 4 && k % 2 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m > kGemvMaxM)
    return (int)launch_mma<BITS>(x, w, cb, n_codes, y, (int)m, (int)n,
                                 (int)k, st);
  const int a = (int)n, b = (int)k;
  switch (m) {
    case 1: return (int)launch_gemv<BITS, 1>(x, w, cb, n_codes, y, a, b, slices, ws, counters, st);
    case 2: return (int)launch_gemv<BITS, 2>(x, w, cb, n_codes, y, a, b, slices, ws, counters, st);
    case 3: return (int)launch_gemv<BITS, 3>(x, w, cb, n_codes, y, a, b, slices, ws, counters, st);
    case 4: return (int)launch_gemv<BITS, 4>(x, w, cb, n_codes, y, a, b, slices, ws, counters, st);
    case 5: return (int)launch_gemv<BITS, 5>(x, w, cb, n_codes, y, a, b, slices, ws, counters, st);
    case 6: return (int)launch_gemv<BITS, 6>(x, w, cb, n_codes, y, a, b, slices, ws, counters, st);
    case 7: return (int)launch_gemv<BITS, 7>(x, w, cb, n_codes, y, a, b, slices, ws, counters, st);
    default: return (int)launch_gemv<BITS, 8>(x, w, cb, n_codes, y, a, b, slices, ws, counters, st);
  }
}

}  // namespace

extern "C" {

// K5: idx (K, N) uint8, 1 <= C <= 256. For M <= 8 (the decode GEMV) the
// K range is cut into `slices` blocks per column tile of 64 columns;
// with more than one, ws holds slices · M · N floats and counters one int
// per column tile, all 0 before the first launch (each launch leaves them
// 0). Launches on `stream` and returns
// the cudaError_t of the launch (0 on success). Does not synchronise.
int quant_matmul_u8(const float* x, const uint8_t* idx, const float* codebook,
                    int n_codes, float* y, long long m, long long n,
                    long long k, int slices, float* ws, int* counters,
                    void* stream) {
  return launch<8>(x, idx, codebook, n_codes, y, m, n, k, slices, ws,
                   counters, stream);
}

// K4: packed (K/2, N) uint8 with K even (an odd-K weight is packed with a
// zero-index pad row and x carries a zero column), 1 <= C <= 16; the
// slices cut the K/2 packed rows.
int quant_matmul_packed4(const float* x, const uint8_t* packed,
                         const float* codebook, int n_codes, float* y,
                         long long m, long long n, long long k, int slices,
                         float* ws, int* counters, void* stream) {
  return launch<4>(x, packed, codebook, n_codes, y, m, n, k, slices, ws,
                   counters, stream);
}


}  // extern "C"
