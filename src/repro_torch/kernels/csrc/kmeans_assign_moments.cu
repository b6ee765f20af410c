// Batched k-means for the grouped C step: assignment + cluster moments
// (K1, K7) and the whole Lloyd loop in one launch.
//
// Replaces the TPU kernel
//   src/repro/kernels/kmeans/kmeans.py:kmeans_assign_moments_batched
//   (body _batched_kernel), and the loop that the JAX package's solver
//   src/repro/kernels/kmeans/ops.py:kmeans_batched runs around it inside
//   one jitted program.
//
// For a packed group w (I, P) f32 with per-item codebooks (I, K) f32
// (K <= 256; entries at or past an item's live count are +inf):
//   assign[i, p] = argmin_k (w[i, p] - cb[i, k])^2, first index on ties;
//   sums[i, k]   = sum of w[i, p] over p with assign[i, p] == k;
//   counts[i, k] = number of such p (int32: exact beyond 2^24 elements).
// Two entry points run the same device code:
//   kmeans_assign_moments_batched: one pass (assign, sums, counts);
//   kmeans_lloyd_batched: `iters` Lloyd steps, each
//     cb = sort(where(counts > 0, sums / float(counts), cb)),
//   then the final assignment, all in one launch.
// A loop of single passes with that update done by torch gives the same
// bits as the fused loop: both take one partition of the elements (the
// wrapper's, a function of I, P, K and the card), one summation order
// and the same f32 update (division rounded to nearest, the count
// converted to f32 to nearest as torch's type promotion does, empty
// clusters keep their entry, +inf tails stay in place).
//
// Bound on the H100. The function reads w once (4 B an element) and
// writes the assignment once (4 B): 8 B an element, for the loop and for
// the single pass alike. Its least operations (one comparison to place an
// element and two adds for its moments, a step) stay below the bytes'
// time. The design's floor is higher: a step needs every element's
// nearest entry for the current codebook, so this design reads w once a
// step and writes the assignment in the final pass alone,
// (4·iters + 8) B an element, except where a block's slice stays in
// shared memory for the whole loop (8 B an element).
//
// Design. A persistent grid of blocks, launched cooperatively for the
// loop (at most kMaxBlocksPerSm an SM, 64 registers a thread) and as a
// plain launch for the single pass. Each block owns one fixed, contiguous
// slice of one item (I <= grid) or whole items in turn (I > grid), read
// with 16-byte loads when the rows allow it; a slice of at most
// 4·kUnroll elements a thread is read once and kept in shared memory for
// the whole loop. Each thread keeps its per-cluster (sum, count) in its
// own column of shared memory ([K][threads], so the lanes of a warp never
// share a bank): one load, two adds and one store an element, whatever K,
// where moments in registers would cost K predicated adds an element. An
// ascending codebook takes a binary search; slices of kTableMin elements
// and more also build, once a step, a table of kBins bins over the
// codebook's range: each bin names the one entry nearest to all its
// elements, or the two around the one decision boundary in it with the
// exact f32 point where the choice flips, so most elements cost one
// lookup and one comparison (exact by construction: see build_lookup).
// A codebook in any other order takes the full scan. A block sums its
// columns in a fixed order into one partial per cluster. In the loop,
// after a grid barrier every block of an item sums that item's partials
// in slice order and applies the update itself (a rank sort of the K
// entries), so a step costs one barrier; partials alternate between two
// buffers by step parity. In the single pass the last block of an item
// to finish, found by a ticket, sums the partials with the same code.
// No float atomics: a rerun gives the same bits.
//
// Chunked groups. The partition (slices an item, bpi) is the wrapper's
// function of I, so a planned group split into chunks would sum each
// item over more slices than the group's one launch. The wrapper gives a
// chunk the whole group's bpi instead (kernels/build.py:group_partition):
// the chunk's launch is the group's launch restricted to its items, bit
// for bit, with no change here, and uses n_chunk/n_group of the grid.
// A partition that depends on P alone would keep every chunk on the
// whole grid, but would put small groups past the grid (I·bpi > grid),
// off their resident slices; the groups that chunk at all are the large
// ones, memory-bound with slices far past shared memory.
//
// Branches, each with the card test (tests/test_torch_cuda.py) that
// reaches it:
//   single pass, plain launch, the ticket's last block reduces:
//     test_lloyd_kernel_branches (every case), chip_smoke.py's K1/K7;
//   fused loop, cooperative launch, one grid barrier a step:
//     test_lloyd_kernel_branches (every case);
//   I <= grid, slices of one item (bpi > 1): the "slices" cases;
//   one block an item (bpi = 1, I <= grid): the "one block an item" case;
//   a single block in all (I = 1, P <= the wrapper's MIN_PER_BLOCK):
//     the "single block" cases;
//   I > grid, whole items in turn, codebooks kept in cb_out between
//     steps: the "past the grid" cases (I from the wrapper's grid);
//   16-byte loads / element loads (P % 4 or w off 16 B): "ragged" and
//     "offset row" cases;
//   resident slice (chunk <= 4·kUnroll·threads): the short-slice cases;
//   lookup: full scan (codebook not ascending): test_lloyd_kernel_
//     unsorted_codebook; binary search: the short-slice cases; table:
//     test_lloyd_table_path_is_exact (also bins with two boundaries and a
//     duplicate entry, which falls back to the search);
//   instances KP = 4, 16, 64 (256 threads) and 256 (64 threads): K = 2,
//     4, 16, 64 and 200 among the cases;
//   +inf tails (mixed K): the "mixed K" cases;
//   count rounded to nearest f32 above 2^24: test_fused_lloyd_rounds_
//     counts_to_nearest.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxK = 256;
constexpr int kMaxBlocksPerSm = 4;
constexpr int kUnroll = 4;             // 16-byte loads in flight a thread
constexpr int kBins = 2048;            // lookup table bins
constexpr int kTableMin = 32768;       // slice elements that build a table
constexpr int kTableMaxK = 64;         // entries a table takes

// How a block finds nearest entries for its current codebook.
struct Lookup {
  int mode;        // 0: full scan (any order), 1: binary search (ascending),
                   // 2: table, then binary search where the table says so
  float lo, inv;   // table: bin = (x - lo) * inv
};

struct LloydArgs {
  const float* w;
  const float* cb0;
  long long p;
  int k;
  int n_items;
  int iters;
  int moments;     // 1: the single pass (iters == 0), sums and counts out
  int bpi;         // slices (blocks) per item
  int n_units;     // n_items * bpi
  long long chunk; // elements a slice, a multiple of 4
  int vec;         // 16-byte loads and stores
  float* cb_out;
  int* assign;
  float* sums;
  int* counts;
  float2* part;    // partials (sum, count bits): the loop's two buffers of
                   // n_units * KP, or the single pass's one
  int* tickets;    // single pass: n_items zeros, left zero
};

// Elements of each of an item's bpi slices: a multiple of 4.
__host__ __device__ inline long long slice_chunk(long long p, int bpi) {
  return ((p + bpi - 1) / bpi + 3) / 4 * 4;
}

// The rule that keeps a block's slice in shared memory for the whole
// loop: one slice a block (multi: more slices than blocks), 16-byte
// loads, at most 4·kUnroll elements a thread of a T-thread block.
__host__ __device__ inline bool slice_resident(bool multi, int vec,
                                               long long chunk, int t) {
  return !multi && vec && chunk <= (long long)t * 4 * kUnroll;
}

__device__ __forceinline__ float sq_dist(float x, float c) {
  const float d = __fsub_rn(x, c);
  return __fmul_rn(d, d);
}

// First index of the least (x - cb[j])^2 for cb ascending, padded with
// +inf to KP entries. pos = #{j : cb[j] <= x}; the f32 distances do not
// increase up to pos - 1 (x - cb[j] >= 0 shrinks, and rounding is
// monotone) and do not decrease from pos on, so the minimum is at
// pos - 1 or pos; equal distances left of pos - 1 (duplicate entries,
// or rounding ties) move it to the first of them.
template <int KP>
__device__ __forceinline__ int nearest_sorted(float x, const float* cb) {
  int pos = 0;
#pragma unroll
  for (int step = KP / 2; step >= 1; step >>= 1)
    if (cb[pos + step - 1] <= x) pos += step;
  if (cb[pos] <= x) ++pos;
  if (pos == 0) return 0;  // also NaN x, and an all-+inf codebook
  const float dl = sq_dist(x, cb[pos - 1]);
  if (pos < KP && sq_dist(x, cb[pos]) < dl) return pos;
  int j = pos - 1;
  while (j > 0 && sq_dist(x, cb[j - 1]) == dl) --j;
  return j;
}

// Any order: the full scan (strict <: the first minimum wins).
__device__ __forceinline__ int nearest_any(float x, const float* cb, int k) {
  float best = INFINITY;
  int arg = 0;
  for (int j = 0; j < k; ++j) {
    const float d = sq_dist(x, cb[j]);
    if (d < best) {
      best = d;
      arg = j;
    }
  }
  return arg;
}

// MODE 2: the bin of x holds (t, j): the answer is j, or j + 1 from the
// f32 threshold t on (t = +inf where no decision boundary crosses the
// bin); j < 0 marks the binary search. x off the table's range takes
// the binary search too.
template <int KP, int MODE>
__device__ __forceinline__ int nearest(float x, const float* cb, int k,
                                       const int2* tbl, const Lookup& lk) {
  if (MODE == 0) return nearest_any(x, cb, k);
  if (MODE == 1) return nearest_sorted<KP>(x, cb);
  // truncation maps x just below the range to bin 0, whose entry (0) is
  // right for every x below c0; NaN converts to 0 as well
  const int b = (int)__fmul_rn(__fsub_rn(x, lk.lo), lk.inv);
  if ((unsigned)b >= (unsigned)kBins) return nearest_sorted<KP>(x, cb);
  const int2 e = tbl[b];
  if (e.y < 0) return nearest_sorted<KP>(x, cb);
  return e.y + (x >= __int_as_float(e.x));
}

// The least float x at which (x - cb[j + 1])^2 < (x - cb[j])^2 in f32
// (cb[j] < cb[j + 1]). Between the two entries the first distance does
// not grow and the second does not shrink with x (monotone rounding), so
// the comparison flips once: a bisection over the floats between them,
// ordered by their bit patterns.
__device__ float flip_point(float c0, float c1) {
  auto key = [](float f) {
    const unsigned u = __float_as_uint(f);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  };
  auto val = [](unsigned kk) {
    return __uint_as_float((kk & 0x80000000u) ? (kk & 0x7fffffffu) : ~kk);
  };
  unsigned lo = key(c0), hi = key(c1);   // false at lo, true at hi
  while (hi - lo > 1) {
    const unsigned mid = lo + (hi - lo) / 2;
    const float x = val(mid);
    if (sq_dist(x, c1) < sq_dist(x, c0)) hi = mid; else lo = mid;
  }
  return val(hi);
}

// #{j < L - 1 : m_j < v} (le: m_j <= v), m_j = 0.5·(cb[j] + cb[j + 1])
// ascending for an ascending cb.
__device__ int mids_below(const float* cb, int L, float v, bool le) {
  int lo = 0, hi = L - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const float m = 0.5f * (cb[mid] + cb[mid + 1]);
    if (le ? m <= v : m < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// 1 when cb[0..k) is ascending (NaN: 0). Ends with a block barrier.
template <int T>
__device__ int check_sorted(const float* cb, int k) {
  int ok = 1;
  for (int j = threadIdx.x; j + 1 < k; j += T) ok &= (cb[j] <= cb[j + 1]);
  return __syncthreads_and(ok);
}

// The block's lookup for the codebook in s_cb (all threads; ends with a
// block barrier). A table covers [c0 - span, c_{L-1} + span] over the L
// finite entries (strictly ascending; else no table) in kBins bins. Each
// bin, widened by a margin far above the f32 rounding of the bin index
// (~3·2^-24·kBins bins), of the decision boundaries (~3·2^-24 of an
// entry gap) and of the midpoints (~2^-24 of |c|), holds no midpoint
// (one candidate, t = +inf), one (its entries j, j + 1 and their exact
// flip point t), or more (the binary search). Exact by construction:
// the table only narrows the candidates, so a pass gives the same
// assignments with or without it.
template <int T, int KP>
__device__ void build_lookup(const float* cb, int k, long long len,
                             int2* tbl, Lookup* lk) {
  __shared__ int s_l;
  __shared__ float s_bw, s_mar;
  __shared__ float s_flip[KP];
  const int sorted = check_sorted<T>(cb, k);
  if (threadIdx.x == 0) {
    Lookup l{sorted ? 1 : 0, 0.f, 0.f};
    if (sorted && len >= kTableMin && KP <= kTableMaxK) {
      int n = 0;
      while (n < k && cb[n] < INFINITY) ++n;
      bool inc = n >= 2;
      for (int j = 0; inc && j + 1 < n; ++j) inc = cb[j] < cb[j + 1];
      const float span = inc ? cb[n - 1] - cb[0] : 0.f;
      if (inc && span > 0.f && span < INFINITY) {
        l.mode = 2;
        l.lo = cb[0] - span;
        const float width = 3.f * span;
        l.inv = (float)kBins / width;
        s_bw = width / (float)kBins;
        s_mar = 0.02f * s_bw +
                4.8e-7f * fmaxf(fabsf(l.lo), fabsf(cb[n - 1] + span));
        s_l = n;
      }
    }
    *lk = l;
  }
  __syncthreads();
  if (lk->mode != 2) return;
  const int n = s_l;
  for (int j = threadIdx.x; j + 1 < n; j += T)
    s_flip[j] = flip_point(cb[j], cb[j + 1]);
  __syncthreads();
  const float bw = s_bw, mar = s_mar, lo = lk->lo;
  for (int b = threadIdx.x; b < kBins; b += T) {
    const int below = mids_below(cb, n, lo + b * bw - mar, false);
    const int upto = mids_below(cb, n, lo + (b + 1) * bw + mar, true);
    tbl[b] = upto == below       ? make_int2(__float_as_int(INFINITY), below)
             : upto == below + 1 ? make_int2(__float_as_int(s_flip[below]),
                                             below)
                                 : make_int2(0, -1);
  }
  __syncthreads();
}

template <int T>
__device__ __forceinline__ void add_moment(float2* acc, int j, float x) {
  float2* slot = acc + j * T + threadIdx.x;
  float2 v = *slot;
  v.x = __fadd_rn(v.x, x);
  v.y += 1.f;
  *slot = v;
}

// One pass of a block over [start, end) of one item: accumulate into the
// thread's column (ACC) and/or write the assignment (STORE). RES: the
// slice's elements are in shared memory xs (loaded once a launch, in the
// order of the streaming loop's first iteration).
template <int T, int KP, int MODE, bool ACC, bool STORE, bool RES>
__device__ __forceinline__ void pass_slice(
    const LloydArgs& a, const float* cb, const int2* tbl, const Lookup& lk,
    float2* acc, long long item, long long start, long long end,
    const float4* xs) {
  const float* wi = a.w + item * a.p;
  int* ai = a.assign + item * a.p;
  const int tid = threadIdx.x;
  if (a.vec) {
    const float4* w4 = reinterpret_cast<const float4*>(wi + start);
    int4* a4 = reinterpret_cast<int4*>(ai + start);
    const long long n4 = (end - start) >> 2;
    for (long long v0 = 0; v0 < n4; v0 += (long long)T * kUnroll) {
      float4 x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long v = v0 + u * T + tid;
        if (RES) x[u] = xs[u * T + tid];
        else if (v < n4) x[u] = __ldg(w4 + v);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long v = v0 + u * T + tid;
        if (v < n4) {
          const int j0 = nearest<KP, MODE>(x[u].x, cb, a.k, tbl, lk);
          const int j1 = nearest<KP, MODE>(x[u].y, cb, a.k, tbl, lk);
          const int j2 = nearest<KP, MODE>(x[u].z, cb, a.k, tbl, lk);
          const int j3 = nearest<KP, MODE>(x[u].w, cb, a.k, tbl, lk);
          if (ACC) {
            add_moment<T>(acc, j0, x[u].x);
            add_moment<T>(acc, j1, x[u].y);
            add_moment<T>(acc, j2, x[u].z);
            add_moment<T>(acc, j3, x[u].w);
          }
          if (STORE) a4[v] = make_int4(j0, j1, j2, j3);
        }
      }
      if (RES) break;
    }
  } else {
    for (long long e = start + tid; e < end; e += T) {
      const float x = __ldg(wi + e);
      const int j = nearest<KP, MODE>(x, cb, a.k, tbl, lk);
      if (ACC) add_moment<T>(acc, j, x);
      if (STORE) ai[e] = j;
    }
  }
}

template <int T, int KP, bool ACC, bool STORE>
__device__ __forceinline__ void pass_dispatch(
    const LloydArgs& a, const float* cb, const int2* tbl, const Lookup& lk,
    bool res, float2* acc, long long item, long long start, long long end,
    const float4* xs) {
  if (lk.mode == 0)
    pass_slice<T, KP, 0, ACC, STORE, false>(a, cb, tbl, lk, acc, item, start,
                                            end, xs);
  else if (lk.mode == 1 && res)
    pass_slice<T, KP, 1, ACC, STORE, true>(a, cb, tbl, lk, acc, item, start,
                                           end, xs);
  else if (lk.mode == 1)
    pass_slice<T, KP, 1, ACC, STORE, false>(a, cb, tbl, lk, acc, item, start,
                                            end, xs);
  else
    pass_slice<T, KP, 2, ACC, STORE, false>(a, cb, tbl, lk, acc, item, start,
                                            end, xs);
}

// The block's partial of unit u: per cluster, the thread columns summed
// lane-strided in order, then a fixed xor tree. Each column entry is read
// once and zeroed for the next pass, which starts after a block barrier.
template <int T, int KP>
__device__ void block_partial(float2* col, int k, float2* part_u) {
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < k; j += T / 32) {
    float s = 0.f;
    int c = 0;
    for (int r = lane; r < T; r += 32) {
      const float2 v = col[j * T + r];
      col[j * T + r] = make_float2(0.f, 0.f);
      s = __fadd_rn(s, v.x);
      c += (int)v.y;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
      c += __shfl_xor_sync(0xffffffffu, c, off);
    }
    if (lane == 0) part_u[j] = make_float2(s, __int_as_float(c));
  }
}

// The item's moments from its bpi partials pi[b * KP + j] (written by
// other blocks: read at L2 with __ldcg, past this SM's L1), into s_sum and
// s_cnt: per cluster, `per` threads take slices g, g + per, ... in order
// (eight loads in flight), then a fixed xor tree in each warp of the
// group, then its warps in order. Ends with a block barrier.
template <int T, int KP>
__device__ void item_moments(const float2* pi, int k, int bpi, float* s_sum,
                             int* s_cnt) {
  __shared__ float s_red[T / 32];
  __shared__ int s_redc[T / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int per = T >= KP ? T / KP : 1;    // threads a cluster
  for (int j0 = 0; j0 < KP; j0 += T / per) {
    const int j = j0 + tid / per;
    const int g = tid % per;
    float s = 0.f;
    int c = 0;
    if (j < k)
      for (int b0 = g; b0 < bpi; b0 += 8 * per) {
        float2 m[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int b = b0 + q * per;
          if (b < bpi) m[q] = __ldcg(pi + (long long)b * KP + j);
        }
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (b0 + q * per < bpi) {
            s = __fadd_rn(s, m[q].x);
            c += __float_as_int(m[q].y);
          }
      }
#pragma unroll
    for (int off = (per < 32 ? per : 32) / 2; off > 0; off >>= 1) {
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
      c += __shfl_xor_sync(0xffffffffu, c, off);
    }
    if (per > 32) {
      if (lane == 0) {
        s_red[warp] = s;
        s_redc[warp] = c;
      }
      __syncthreads();
      if (g == 0) {
        s = 0.f;
        c = 0;
        for (int v = 0; v < per / 32; ++v) {
          s = __fadd_rn(s, s_red[warp + v]);
          c += s_redc[warp + v];
        }
      }
    }
    if (g == 0 && j < k) {
      s_sum[j] = s;
      s_cnt[j] = c;
    }
    __syncthreads();
  }
}

// Starts and ends with a block barrier: no thread still reads the old one.
template <int T, int KP>
__device__ void load_codebook(float* s_cb, const float* src, int k) {
  __syncthreads();
  for (int j = threadIdx.x; j < KP; j += T)
    s_cb[j] = j < k ? __ldcg(src + j) : INFINITY;
  __syncthreads();
}

// (at most 64 registers a thread: kMaxBlocksPerSm blocks of 256 threads
// an SM keep enough loads in flight at LM width)
template <int T, int KP>
__global__ void __launch_bounds__(T, 4)
lloyd_kernel(LloydArgs a) {
  extern __shared__ float2 s_col[];          // [KP][T] (sum, count)
  __shared__ float s_cb[KP];
  __shared__ float s_new[KP];
  __shared__ float s_sum[KP];
  __shared__ int s_cnt[KP];
  __shared__ int2 s_tbl[kBins];
  __shared__ Lookup s_lk;
  __shared__ int s_last;
  const int tid = threadIdx.x;
  const int k = a.k;
  // I <= grid: one unit (item slice) a block, its codebook kept in shared
  // memory; I > grid (the loop only): whole items, their codebooks kept
  // in cb_out between steps
  const bool multi = a.n_units > (int)gridDim.x;
  // a slice of at most T·4·kUnroll elements stays in shared memory (xs,
  // the table's space: a table is built for long slices only)
  const bool res = slice_resident(multi, a.vec, a.chunk, T);
  float4* xs = reinterpret_cast<float4*>(s_tbl);
  static_assert(sizeof(int2) * kBins >= sizeof(float4) * kUnroll * T,
                "the resident slice fits the table's space");
  for (int j = 0; j < KP; ++j) s_col[j * T + tid] = make_float2(0.f, 0.f);
  if (multi) {
    for (int u = blockIdx.x; u < a.n_units; u += gridDim.x)
      for (int j = tid; j < k; j += T)
        a.cb_out[(long long)u * k + j] = a.cb0[(long long)u * k + j];
    __syncthreads();
  } else {
    const long long item = blockIdx.x / a.bpi;
    const long long start = min(a.p, (blockIdx.x % a.bpi) * a.chunk);
    const long long end = min(a.p, start + a.chunk);
    load_codebook<T, KP>(s_cb, a.cb0 + item * k, k);
    build_lookup<T, KP>(s_cb, k, end - start, s_tbl, &s_lk);
    if (res) {
      const float4* w4 = reinterpret_cast<const float4*>(a.w + item * a.p +
                                                         start);
      const long long n4 = (end - start) >> 2;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long v = u * T + tid;
        xs[v] = v < n4 ? __ldg(w4 + v) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }

  for (int step = 0; step <= a.iters; ++step) {
    const bool last = step == a.iters;
    const bool acc = !last || a.moments;
    float2* part = a.part + (long long)(step & 1) * a.n_units * KP;
    for (int u = blockIdx.x; u < a.n_units; u += gridDim.x) {
      const long long item = u / a.bpi;
      const long long start = min(a.p, (u % a.bpi) * a.chunk);
      const long long end = min(a.p, start + a.chunk);
      if (multi) {
        load_codebook<T, KP>(s_cb, a.cb_out + item * k, k);
        build_lookup<T, KP>(s_cb, k, end - start, s_tbl, &s_lk);
      }
      const Lookup lk = s_lk;
      if (!acc) {
        pass_dispatch<T, KP, false, true>(a, s_cb, s_tbl, lk, res, s_col,
                                          item, start, end, xs);
        continue;
      }
      if (last)
        pass_dispatch<T, KP, true, true>(a, s_cb, s_tbl, lk, res, s_col,
                                         item, start, end, xs);
      else
        pass_dispatch<T, KP, true, false>(a, s_cb, s_tbl, lk, res, s_col,
                                          item, start, end, xs);
      __syncthreads();
      block_partial<T, KP>(s_col, k, part + (long long)u * KP);
      __syncthreads();   // the columns are zero; the next unit may start
    }
    if (!acc) break;

    if (a.moments) {
      // the single pass: the item's last block to finish sums its partials
      const long long item = blockIdx.x / a.bpi;
      __threadfence();
      __syncthreads();
      if (tid == 0) s_last = atomicAdd(a.tickets + item, 1) == a.bpi - 1;
      __syncthreads();
      if (!s_last) return;
      item_moments<T, KP>(part + item * a.bpi * KP, k, a.bpi, s_sum, s_cnt);
      for (int j = tid; j < k; j += T) {
        a.sums[item * k + j] = s_sum[j];
        a.counts[item * k + j] = s_cnt[j];
      }
      if (tid == 0) a.tickets[item] = 0;
      return;
    }
    cg::this_grid().sync();

    // every block of an item sums that item's partials and updates it
    for (int u = blockIdx.x; u < a.n_units; u += gridDim.x) {
      const long long item = u / a.bpi;
      const long long slice = u % a.bpi;
      item_moments<T, KP>(part + item * a.bpi * KP, k, a.bpi, s_sum, s_cnt);
      if (multi) load_codebook<T, KP>(s_cb, a.cb_out + item * k, k);
      // the update, as torch computes it: where(counts > 0, sums /
      // float(counts), cb), then an ascending sort (a rank sort, ties in
      // index order)
      for (int j = tid; j < k; j += T) {
        const int c = s_cnt[j];
        s_new[j] = c > 0 ? __fdiv_rn(s_sum[j], __int2float_rn(c)) : s_cb[j];
      }
      __syncthreads();
      for (int j = tid; j < k; j += T) {
        const float v = s_new[j];
        int r = 0;
        for (int i = 0; i < k; ++i) {
          const float o = s_new[i];
          r += (o < v) || (o == v && i < j);
        }
        s_cb[r] = v;
      }
      __syncthreads();
      if (multi) {   // (the next pass loads it and builds its lookup)
        for (int j = tid; j < k; j += T) a.cb_out[item * k + j] = s_cb[j];
      } else {
        build_lookup<T, KP>(s_cb, k,
                            min(a.p, (slice + 1) * a.chunk) -
                                min(a.p, slice * a.chunk),
                            s_tbl, &s_lk);
      }
    }
  }
  if (!multi && !a.moments && blockIdx.x % a.bpi == 0)
    for (int j = tid; j < k; j += T)
      a.cb_out[(long long)(blockIdx.x / a.bpi) * k + j] = s_cb[j];
}

// Blocks of one instance that fit on the current card at once, at most
// kMaxBlocksPerSm an SM (0 on an error). Also allows the instance its
// dynamic shared memory on this card.
template <int T, int KP>
int grid_blocks() {
  const int smem = KP * T * (int)sizeof(float2);
  int dev = 0, per_sm = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaFuncSetAttribute(lloyd_kernel<T, KP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, lloyd_kernel<T, KP>, T, smem) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return (per_sm < kMaxBlocksPerSm ? per_sm : kMaxBlocksPerSm) * sms;
}

// grid < 1: the single pass (a plain launch of n_units blocks); else the
// loop, a cooperative launch of min(n_units, grid) blocks.
template <int T, int KP>
int launch(LloydArgs a, int grid, long long ws_bytes, cudaStream_t stream) {
  a.n_units = a.n_items * a.bpi;
  a.chunk = slice_chunk(a.p, a.bpi);
  const long long n_part = grid < 1 ? 1 : 2;
  // per-thread counts are f32 in shared memory: exact below 2^24
  if (a.chunk / T >= (1LL << 24) ||
      n_part * a.n_units * KP * (long long)sizeof(float2) > ws_bytes ||
      (grid >= 1 && a.n_units > grid && a.bpi != 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = KP * T * sizeof(float2);
  if (grid < 1) {
    lloyd_kernel<T, KP><<<a.n_units, T, smem, stream>>>(a);
    return (int)cudaGetLastError();
  }
  void* args[] = {&a};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)lloyd_kernel<T, KP>,
      dim3(a.n_units < grid ? a.n_units : grid), dim3(T), args, smem, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

int run(const float* w, const float* cb0, long long n_items, long long p,
        int k, int iters, int bpi, int grid, float* cb_out, int* assign,
        float* sums, int* counts, int* tickets, void* ws, long long ws_bytes,
        void* stream) {
  if (n_items < 1 || p < 1 || k < 1 || k > kMaxK || iters < 0 || bpi < 1 ||
      n_items * bpi > 0x7fffffffLL || n_items * (long long)k > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  LloydArgs a{};
  a.w = w;
  a.cb0 = cb0;
  a.p = p;
  a.k = k;
  a.n_items = (int)n_items;
  a.iters = iters;
  a.moments = grid < 1;
  a.bpi = bpi;
  a.cb_out = cb_out;
  a.assign = assign;
  a.sums = sums;
  a.counts = counts;
  a.part = static_cast<float2*>(ws);
  a.tickets = tickets;
  // the same rule for every launch on one w, so a loop of single passes
  // and the fused loop share one partition
  a.vec = (p % 4 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  if (a.vec && reinterpret_cast<uintptr_t>(assign) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 4) return launch<256, 4>(a, grid, ws_bytes, s);
  if (k <= 16) return launch<256, 16>(a, grid, ws_bytes, s);
  if (k <= 64) return launch<256, 64>(a, grid, ws_bytes, s);
  return launch<64, 256>(a, grid, ws_bytes, s);
}

}  // namespace

extern "C" {

// The blocks of the instance for K that fit on the current card at once
// (at most kMaxBlocksPerSm an SM): the loop's largest grid. 0 on an error.
int kmeans_grid_blocks(int k) {
  if (k <= 4) return grid_blocks<256, 4>();
  if (k <= 16) return grid_blocks<256, 16>();
  if (k <= 64) return grid_blocks<256, 64>();
  return grid_blocks<64, 256>();
}

// 1 when the loop over w (I, P) at 16-byte loads (`vec`) keeps each
// block's slice in shared memory (w read once, not once a step), for
// `bpi` slices an item on a grid of `grid` blocks.
int kmeans_slice_resident(long long n_items, long long p, int k, int bpi,
                          int grid, int vec) {
  const int t = k <= 64 ? 256 : 64;
  return slice_resident(n_items * bpi > grid, vec, slice_chunk(p, bpi), t);
}

// One pass: assign (I, P) i32, sums (I, K) f32, counts (I, K) i32 for the
// codebooks (any order; an ascending one takes the binary search), over
// `bpi` slices an item. `ws` is the caller's partials workspace of
// `ws_bytes` (I · bpi · KP · 8 B, KP = 4, 16, 64 or 256 for K <= 4, 16,
// 64, 256); `tickets` holds I zeroed ints, left zero. Returns the
// cudaError_t of the launch (0 on success); does not synchronise.
int kmeans_assign_moments_batched(const float* w, const float* codebooks,
                                  long long n_items, long long p, int k,
                                  int bpi, int* assign, float* sums,
                                  int* counts, int* tickets, void* ws,
                                  long long ws_bytes, void* stream) {
  return run(w, codebooks, n_items, p, k, 0, bpi, 0, nullptr, assign, sums,
             counts, tickets, ws, ws_bytes, stream);
}

// The Lloyd loop: `iters` steps from the ascending codebooks (+inf tails)
// `codebooks`, then the final assignment: cb_out (I, K), assign (I, P).
// `grid` (from kmeans_grid_blocks) bounds the cooperative grid; with
// I · bpi > grid, bpi must be 1 (whole items in turn). `ws` holds
// 2 · I · bpi · KP · 8 B. A grid the card cannot place is refused.
int kmeans_lloyd_batched(const float* w, const float* codebooks,
                         long long n_items, long long p, int k, int iters,
                         int bpi, int grid, float* cb_out, int* assign,
                         void* ws, long long ws_bytes, void* stream) {
  if (grid < 1) return (int)cudaErrorInvalidValue;
  return run(w, codebooks, n_items, p, k, iters, bpi, grid, cb_out, assign,
             nullptr, nullptr, nullptr, ws, ws_bytes, stream);
}

}  // extern "C"
