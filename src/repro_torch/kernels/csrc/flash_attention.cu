// Fused flash-attention forward: causal (+ sliding window), GQA-native, on
// the tensor cores at f32 accuracy.
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py:flash_attention
//   (body _kernel).
//
// For q (B, KV, G, S, D), k (B, KV, S, D) and v (B, KV, S, DV), all f32
// and contiguous:
//   o[b, h, g, i] = sum_j softmax_j(q[b,h,g,i] . k[b,h,j] * scale) v[b,h,j]
// over keys j <= i (and j > i - window when window > 0); o is
// (B, KV, G, S, DV). The caller gives the scale (1/sqrt(D) for GQA, and for
// MLA 1/sqrt(qk_nope + qk_rope)). V's head dim DV is the second template
// parameter: DV == D for every D, and MLA's (96, 64) (minicpm3-4b). The
// (S, S) score matrix never reaches device memory.
//
// Bound on the H100: the kernel reads q, k, v and writes o once, and does
// 4·D operations per (query, key) pair it keeps. Both products run on the
// tensor cores as TF32 mma.sync.m16n8k8 with the 3-pass split (below), so
// the operations bound is 3 · 4·D·pairs at 495 TFLOP/s (TF32 dense); at
// the main path's S = 512, D = 96 that is above the bytes bound at
// 3.35 TB/s. What the design does about it:
//   * f32 accuracy from TF32 products: each operand x = hi + lo with
//     hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest as
//     cvt.rna does; every product accumulates lo·hi + hi·lo, then hi·hi,
//     in f32 (lo·lo is below f32's rounding). One TF32 pass keeps ~3
//     decimal digits, too few for the reference's rtol/atol 2e-4. The
//     split, not the tensor cores, sets the pace: each warp splits every
//     K and V element it reads (2 + 3 integer and float instructions
//     beside 1.5 mma per element); splitting once per block into shared
//     memory measured slower, bound by the doubled shared-memory reads;
//   * the softmax runs in registers: each warp owns 16 query rows, the
//     score fragment never leaves registers, row max and sum take quad
//     shuffles, exp2f with scale·log2(e) folded in. The score accumulator
//     feeds P·V as its A operand without any data movement: within each
//     8-key step the keys are taken in the order (0,2,4,6 | 1,3,5,7), which
//     is where the m16n8k8 accumulator layout already holds them, and the
//     V fragments are read in the same order;
//   * K/V tiles of 64 keys come in with cp.async (16 B per thread) into two
//     shared-memory stages, so the next tile loads while this one
//     computes; rows are padded to D + 4 floats so that every fragment
//     read of Q, K and V falls in 32 distinct banks;
//   * one block per (q tile, kv head, batch) holds all G query heads of
//     its kv head (64 query rows = G heads × 64/G positions), so each K/V
//     tile is read once per group (the GQA sharing of the Pallas
//     BlockSpecs that ignore g); the Pallas kernel's sequential kv grid
//     axis becomes a loop inside the block;
//   * the grid is 1-D with the q tiles in reverse order, so the longest
//     causal rows start first and the short ones fill the tail; kv tiles
//     wholly above the diagonal or outside the window are skipped, and
//     only tiles that cross the diagonal or the window edge are masked;
//   * at D = 96 a block takes 100 KB of shared memory (84 KB at (96, 64)),
//     so two fit on an SM.
// Numerics follow the Pallas kernel: masked scores are NEG_INF = -1e30
// (here in units of log2), l is clamped at 1e-30; any S, the ragged tail
// of queries and keys is zero-filled and masked in the kernel. No atomics:
// a rerun gives the same bits.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps × 16 query rows
constexpr int kRows = 64;      // query rows per block
constexpr int kKv = 64;        // keys per kv tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// floats of one padded K or V tile of head dim W; stage st holds K then V
template <int W>
__host__ __device__ constexpr int tile_floats() { return kKv * (W + 4); }

// x rounded to TF32, to nearest with ties away from zero: the result of
// cvt.rna.tf32.f32, which sm_90a emulates in ~6 instructions; an add and a
// mask on the bits take 2
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a·b at f32 accuracy: the small terms first, then hi·hi
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma(c, al, bh0, bh1);
  mma(c, ah, bl0, bl1);
  mma(c, ah, bh0, bh1);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool live) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(live ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// rows [0, 64) of a padded tile of head dim W from `base` rows
// first_row + r (zero past s)
template <int W>
__device__ __forceinline__ void load_kv(float* dst, const float* base,
                                        int first_row, int s) {
  constexpr int C4 = W / 4;
  for (int e = threadIdx.x; e < kKv * C4; e += kThreads) {
    const int r = e / C4, c = (e % C4) * 4;
    const int pos = first_row + r;
    const bool live = pos < s;
    cp_async16(dst + r * (W + 4) + c,
               live ? base + (int64_t)pos * W + c : base, live);
  }
}

// 1-D grid over n_q_tiles × n_heads blocks (n_heads = B·KV), q tiles in
// reverse; bq = query positions per tile (kRows / G)
template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int s, int g, int bq, int window, float scale_log2,
                       int n_q_tiles, int64_t n_heads) {
  constexpr int SK = D + 4, SV = DV + 4;
  constexpr int KS = D / 8;   // k-steps of Q·Kᵀ
  constexpr int NS = DV / 8;  // n-tiles of P·V
  constexpr int KT = tile_floats<D>();
  constexpr int STAGE = KT + tile_floats<DV>();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int64_t blk = blockIdx.x;
  const int qt = n_q_tiles - 1 - (int)(blk / n_heads);
  const int64_t hk = blk % n_heads;           // b·KV + kv head
  const int q0 = qt * bq;
  const int rows = g * bq;                    // live rows of this block
  const int64_t head0 = hk * g;
  const float* kb = k + hk * (int64_t)s * D;
  const float* vb = v + hk * (int64_t)s * DV;

  const int q_last = min(q0 + bq, s) - 1;
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / kKv;
  const int kt_end = q_last / kKv;

  // the Q tile goes through stage 1's K buffer; row r is query head
  // head0 + r / bq at position q0 + r % bq
  {
    constexpr int C4 = D / 4;
    float* qs = smem + STAGE;
    for (int e = threadIdx.x; e < kRows * C4; e += kThreads) {
      const int r = e / C4, c = (e % C4) * 4;
      const int pos = q0 + r % bq;
      const bool live = r < rows && pos < s;
      cp_async16(qs + r * SK + c,
                 live ? q + ((head0 + r / bq) * s + pos) * D + c : q, live);
    }
    cp_async_commit();
  }
  load_kv<D>(smem, kb, kt_begin * kKv, s);
  load_kv<DV>(smem + KT, vb, kt_begin * kKv, s);
  cp_async_commit();
  cp_async_wait_one();                        // the Q tile has landed
  __syncthreads();

  // this warp's 16 rows of Q as A fragments (raw f32, split per use)
  const int r0 = warp * 16 + gid, r1 = r0 + 8;
  float qf[KS][4];
  {
    const float* qs = smem + STAGE + r0 * SK + tig;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      qf[kk][0] = qs[8 * kk];
      qf[kk][1] = qs[8 * SK + 8 * kk];
      qf[kk][2] = qs[8 * kk + 4];
      qf[kk][3] = qs[8 * SK + 8 * kk + 4];
    }
  }
  __syncthreads();                            // stage 1 is free

  const int qpos0 = q0 + r0 % bq, qpos1 = q0 + r1 % bq;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float acc[NS][4];
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int kt = kt_begin, st = 0; kt <= kt_end; ++kt, st ^= 1) {
    if (kt < kt_end) {
      float* nxt = smem + (st ^ 1) * STAGE;
      load_kv<D>(nxt, kb, (kt + 1) * kKv, s);
      load_kv<DV>(nxt + KT, vb, (kt + 1) * kKv, s);
    }
    cp_async_commit();
    cp_async_wait_one();                      // tile kt has landed
    __syncthreads();
    const float* ks = smem + st * STAGE;
    const float* vs = ks + KT;

    // scores: sc[n] holds rows (gid, gid + 8) × keys 8n + 2tig + {0, 1}
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // split Q per tile: hoisted out of the kv loop, the split halves
        // would take D more registers and spill
        asm volatile("" : "+f"(qf[kk][i]));
        split(qf[kk][i], ah[i], al[i]);
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float* kp = ks + (8 * n + gid) * SK + 8 * kk + tig;
        mma3(sc[n], ah, al, kp[0], kp[4]);
      }
    }

    const int k0 = kt * kKv;
    const bool masked = k0 + kKv - 1 > q0 ||
                        (window > 0 && k0 <= q_last - window);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = sc[n][i] * scale_log2;
        if (masked) {
          const int kpos = k0 + 8 * n + 2 * tig + (i & 1);
          const int qpos = i < 2 ? qpos0 : qpos1;
          const bool ok = kpos <= qpos && (window <= 0 || kpos > qpos - window);
          x = ok ? x : kNegInf;
        }
        sc[n][i] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      sc[n][0] = exp2f(sc[n][0] - mn0);
      sc[n][1] = exp2f(sc[n][1] - mn0);
      sc[n][2] = exp2f(sc[n][2] - mn1);
      sc[n][3] = exp2f(sc[n][3] - mn1);
      sum0 += sc[n][0] + sc[n][1];
      sum1 += sc[n][2] + sc[n][3];
    }
    l0 = l0 * alpha0 + sum0;                  // this thread's columns only
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }

    // acc += P V over the 8-key steps j; A's k index tig ↔ key 2·tig and
    // tig + 4 ↔ key 2·tig + 1, so sc[j] is the A fragment as it stands
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t ah[4], al[4];
      split(sc[j][0], ah[0], al[0]);
      split(sc[j][2], ah[1], al[1]);
      split(sc[j][1], ah[2], al[2]);
      split(sc[j][3], ah[3], al[3]);
      const float* vp = vs + (8 * j + 2 * tig) * SV + gid;
#pragma unroll
      for (int n = 0; n < NS; ++n)
        mma3(acc[n], ah, al, vp[8 * n], vp[SV + 8 * n]);
    }
    __syncthreads();                          // the next loads reuse stage st
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if (r0 < rows && qpos0 < s) {
    const float inv = 1.f / fmaxf(l0, 1e-30f);
    float* out = o + ((head0 + r0 / bq) * s + qpos0) * DV + 2 * tig;
#pragma unroll
    for (int n = 0; n < NS; ++n)
      *reinterpret_cast<float2*>(out + 8 * n) =
          make_float2(acc[n][0] * inv, acc[n][1] * inv);
  }
  if (r1 < rows && qpos1 < s) {
    const float inv = 1.f / fmaxf(l1, 1e-30f);
    float* out = o + ((head0 + r1 / bq) * s + qpos1) * DV + 2 * tig;
#pragma unroll
    for (int n = 0; n < NS; ++n)
      *reinterpret_cast<float2*>(out + 8 * n) =
          make_float2(acc[n][2] * inv, acc[n][3] * inv);
  }
}

template <int D, int DV>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   long long b, long long kvh, long long g, long long s,
                   int window, float scale, cudaStream_t stream) {
  constexpr size_t bytes =
      sizeof(float) * 2 * (tile_floats<D>() + tile_floats<DV>());
  // The attribute is per device, so set it on every launch (it is cheap):
  // a once-per-process flag would miss a second card.
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int bq = kRows / (int)g;
  const long long n_q_tiles = (s + bq - 1) / bq;
  const long long n_heads = b * kvh;
  if (n_q_tiles * n_heads > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_attention_kernel<D, DV>
      <<<(unsigned)(n_q_tiles * n_heads), kThreads, bytes, stream>>>(
          q, k, v, o, (int)s, (int)g, bq, window, scale * kLog2e,
          (int)n_q_tiles, n_heads);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, KV, G, S, D), k (B, KV, S, D), v (B, KV, S, DV), o (B, KV, G, S,
// DV); all f32, contiguous and 16-byte aligned. (D, DV) is (D, D) for D in
// {8, 16, 32, 64, 96, 128}, or (96, 64); 1 <= G <= 64, B and KV <= 65535.
// Launches on `stream` and returns the cudaError_t of the launch (0 on
// success). Does not synchronise.
int flash_attention_fwd(const float* q, const float* k, const float* v,
                        float* o, long long b, long long kvh, long long g,
                        long long s, int d, int dv, int window, float scale,
                        void* stream) {
  if (b < 1 || b > 65535 || kvh < 1 || kvh > 65535 || g < 1 || g > kRows ||
      s < 1 || s > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if ((((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) & 15u) !=
      0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 96 && dv == 64)
    return (int)launch<96, 64>(q, k, v, o, b, kvh, g, s, window, scale, st);
  if (dv != d) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 8: return (int)launch<8, 8>(q, k, v, o, b, kvh, g, s, window, scale, st);
    case 16: return (int)launch<16, 16>(q, k, v, o, b, kvh, g, s, window, scale, st);
    case 32: return (int)launch<32, 32>(q, k, v, o, b, kvh, g, s, window, scale, st);
    case 64: return (int)launch<64, 64>(q, k, v, o, b, kvh, g, s, window, scale, st);
    case 96: return (int)launch<96, 96>(q, k, v, o, b, kvh, g, s, window, scale, st);
    case 128: return (int)launch<128, 128>(q, k, v, o, b, kvh, g, s, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
