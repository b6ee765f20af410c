// Batched threshold counts (K2, K8) and the whole top-κ bisection of the
// ℓ0 C step in one launch.
//
// Replaces the TPU kernel
//   src/repro/kernels/prune/prune.py:count_above_batched
//   (body _count_batched_kernel), and the bisection that the JAX
//   package's solver src/repro/kernels/prune/ops.py:topk_mask_batched runs
//   around it inside one jitted program (a lax.fori_loop).
//
// Two entry points run the same kernel:
//   count_above_batched: counts[i] = #{p : |w[i, p]| >= t[i]}
//     (strict: > t[i]), int32, exact for any P < 2^31;
//   topk_threshold_batched: per item, hi = s·max|w| + a, lo = 0, then
//     `iters` steps of mid = 0.5·(lo + hi), lo = mid where
//     count(|w| >= mid) >= κ, else hi = mid; then n_hi = count(|w| >= hi).
//     `strict` takes the single-vector rules instead (K8's loop): counts
//     of |w| > t, hi = max|w| (s = 1, a = 0), and lo moves where the
//     count exceeds κ. The f32 steps are __fadd_rn/__fmul_rn, as torch
//     rounds them, and the counts are exact, so (lo, hi, n_hi) equal a
//     loop of single counts with the update done by torch, bit for bit.
//
// Bound on the H100: the function reads w once, 4 B an element, for the
// bisection and for the single count alike, and does a compare an
// element a step; the bytes bound it. The design's floor is higher: it
// reads w fully once for the max and then in the steps up to the first
// compaction, less those whose mid lies above the item's max (their count
// is 0, known without a pass), so (1 + such steps) · 4 B an element, plus
// the band's passes. The exact counts c_lo = count(>= lo) and c_hi =
// count(>= hi) are known after every step; once the band [lo, hi) of an
// item holds at most 1/kShareDen of the elements that the current step
// reads, the next step's pass also copies the band's magnitudes, in any
// order, into a workspace, and the later steps count over it, adding c_hi
// of the compaction. The copy cannot overflow its buffer: its size,
// c_lo - c_hi, is known before it. Counts stay exact, so the thresholds
// do not change. Compaction repeats between two buffers while the band
// keeps shrinking; n_hi = c_hi needs no pass.
//
// Design. A grid of blocks, launched cooperatively for the bisection (at
// most kMaxBlocksPerSm an SM) and as a plain launch for the single count.
// Each block owns a fixed, contiguous slice of one item's current source
// (w or its compacted band), or whole items in turn (I > grid), read with
// 16-byte loads where aligned. In the bisection a block's count goes to
// a partial, and after a grid barrier the blocks sum the partials and
// apply the same update, so a step costs one barrier. The single count
// takes the same partition and adds each block's count to the item's
// integer counter (exact in any order); the item's last block to finish,
// found by a ticket, takes the sum. Band
// elements are staged per warp in shared memory and placed kStage at a
// time by one integer atomic on a per-item counter; the counters are zero
// on entry and the launch leaves them zero. For I <= kMaxTracked every
// block keeps every item's state, so once every band is compacted to at
// most kLocal elements all blocks agree to stop, and each item's first
// block finishes the bisection alone from shared memory with block
// barriers only. No float atomics, no host sync.
//
// Branches, each with the card test (tests/test_torch_cuda.py) that
// reaches it:
//   single count, plain launch, the ticket's last block takes the sum,
//   and the bisection, cooperative launch: test_bisection_kernel_branches
//     (every case runs both), chip_smoke.py's K2/K8 and fused phase;
//   I <= kMaxTracked (every block keeps every item's state) / kMaxTracked
//     < I <= grid (a block keeps its own item's) / I > grid (states in
//     the workspace, whole items in turn, the count at I > grid too):
//     the "tracked", "own item" and "past the grid" cases;
//   16-byte loads / element loads: the "ragged" and "offset row" cases;
//   steps whose mid lies above max|w| skip their pass: every non-strict
//     case (its first steps: hi starts at 2·max|w| + 1);
//   compaction, once and repeated between the two buffers: the
//     "compacts" cases (with_stats shows the count and the first step);
//     off (iters <= 2): the "no compaction" case;
//   the one-block finish from shared memory: the "compacts" case
//     (with_stats shows the step it began);
//   strict / non-strict rules, tied magnitudes: every case runs both, on
//     weights with ties.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocksPerSm = 4;
constexpr int kUnroll = 4;             // 16-byte loads in flight a thread
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStage = 128;            // band elements a warp reserves at once
constexpr int kMaxTracked = 8;         // items whose states every block keeps
constexpr int kLocal = 4096;           // band elements a one-block finish takes
// compact a band of at most 1/kShareDen of its source: at w_down's κ = 5%
// it compacts right after the first step that moves lo, as 1/8 does, and
// the two buffers take 2/16 of w
constexpr int kShareDen = 16;

// per-item bisection state
struct State {
  float amax;          // max |w|
  float lo, hi;
  int c_lo, c_hi;      // count(>= lo) (an upper bound until lo moves, if
                       // strict) and count(>= hi), exact
  int base;            // count(>= hi) at the compaction of the source
  int src;             // 0: w, 1 or 2: band buffer
  int src_len;         // elements of the source
  int compact;         // 1: this step's pass copies the band
  int fresh;           // 1: the last update read a compaction's counter
  int events;          // compactions so far
  int first;           // step of the first compaction, -1: none
  int w_passes;        // passes over all of w (the max's included)
};

struct TopkArgs {
  const float* w;
  const int* kappa;
  const float* t;
  long long p;
  int n_items;
  int iters;
  int bisect;          // 0: counts at t (count_above_batched)
  int strict;
  int off;             // lo moves where count >= κ + off
  float hi_scale, hi_add;
  long long cap;       // band buffer elements an item, a multiple of 4
  int max_events;
  int bpi;
  int n_units;
  int vec;
  int* out;            // counts (I,), or (7, I): lo, hi (f32 bits), n_hi,
                       // compactions, first compaction step, passes
                       // over all of w, first step of the one-block
                       // finish (-1: none)
  int* part;           // 2 * n_units
  State* st;           // n_items (I > grid and I > kMaxTracked)
  float* band;         // 2 * n_items * cap
  int* ctr;            // n_items * max_events, zero on entry and on exit
  int* tickets;        // single count: 2 * n_items zeros (tickets, then
                       // the items' counts), left zero
};

__device__ __forceinline__ bool above(float a, float t, int strict) {
  return strict ? a > t : a >= t;
}

__device__ __forceinline__ bool in_band(float a, float lo, float hi,
                                        int strict) {
  return strict ? (a > lo && a <= hi) : (a >= lo && a < hi);
}

// Calls f(x, ok) for every element of src[start, end) in a fixed
// per-thread order, the same number of times in every thread of the
// block (ok false past the end), so f may use warp collectives.
template <typename F>
__device__ __forceinline__ void for_range(const float* src, long long start,
                                          long long end, bool vec, F f) {
  const int tid = threadIdx.x;
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src + start);
    const long long n4 = (end - start) >> 2;
    for (long long v0 = 0; v0 < n4; v0 += (long long)kThreads * kUnroll) {
      float4 x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long v = v0 + u * kThreads + tid;
        x[u] = v < n4 ? __ldcg(s4 + v) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool ok = v0 + u * kThreads + tid < n4;
        f(x[u].x, ok);
        f(x[u].y, ok);
        f(x[u].z, ok);
        f(x[u].w, ok);
      }
    }
    start += n4 * 4;
  }
  for (long long e0 = start; e0 < end; e0 += kThreads) {
    const long long e = e0 + tid;
    const bool ok = e < end;
    f(ok ? __ldcg(src + e) : 0.f, ok);
  }
}

__device__ int block_sum(int c, int* s_warp) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(kFull, c, off);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = c;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int v = 0; v < kWarps; ++v) total += s_warp[v];
  __syncthreads();
  return total;
}

__device__ float block_max(float m, float* s_warp) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = m;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int v = 0; v < kWarps; ++v) total = fmaxf(total, s_warp[v]);
  __syncthreads();
  return total;
}

// The sum (or max) of an item's partials by one warp: lane-strided, then
// a shuffle tree (integer adds and max are exact in any order).
__device__ __forceinline__ int warp_sum_partials(const int* pi, int n) {
  int c = 0;
  for (int b = threadIdx.x & 31; b < n; b += 32) c += __ldcg(pi + b);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(kFull, c, off);
  return c;
}

__device__ __forceinline__ float warp_max_partials(const int* pi, int n) {
  float m = 0.f;
  for (int b = threadIdx.x & 31; b < n; b += 32)
    m = fmaxf(m, __int_as_float(__ldcg(pi + b)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  return m;
}

__device__ __forceinline__ void slice_range(long long len, int bpi,
                                            long long slice, long long* start,
                                            long long* end) {
  const long long chunk = ((len + bpi - 1) / bpi + 3) / 4 * 4;
  *start = min(len, slice * chunk);
  *end = min(len, *start + chunk);
}

// Counts |x| above mid over src[start, end); with `dest`, also copies the
// band's magnitudes there, staged per warp in shared memory and
// reserved kStage at a time from the item's counter (one atomic per
// kStage band elements, not one per warp and element).
__device__ int count_pass(const float* src, long long start, long long end,
                          bool vec, float mid, const State& s, int strict,
                          float* dest, int* ctr, float* stage) {
  int c = 0;
  if (dest == nullptr) {
    for_range(src, start, end, vec, [&](float x, bool ok) {
      c += ok && above(fabsf(x), mid, strict);
    });
    return c;
  }
  const int lane = threadIdx.x & 31;
  int cur = 0;   // the warp's staged elements (the same in every lane)
  for_range(src, start, end, vec, [&](float x, bool ok) {
    const float m = fabsf(x);
    c += ok && above(m, mid, strict);
    const bool in = ok && in_band(m, s.lo, s.hi, strict);
    const unsigned mask = __ballot_sync(kFull, in);
    if (in) stage[cur + __popc(mask & ((1u << lane) - 1u))] = m;
    cur += __popc(mask);
    if (cur >= kStage) {
      __syncwarp();
      int b = 0;
      if (lane == 0) b = atomicAdd(ctr, kStage);
      b = __shfl_sync(kFull, b, 0);
      for (int q = lane; q < kStage; q += 32) dest[b + q] = stage[q];
      __syncwarp();
      if (lane < cur - kStage) stage[lane] = stage[kStage + lane];
      __syncwarp();
      cur -= kStage;
    }
  });
  __syncwarp();
  if (cur > 0) {
    int b = 0;
    if (lane == 0) b = atomicAdd(ctr, cur);
    b = __shfl_sync(kFull, b, 0);
    for (int q = lane; q < cur; q += 32) dest[b + q] = stage[q];
  }
  return c;
}

// A pass is needed unless every |w| of the item lies below mid (known
// from its max): then the count is 0 exactly. A pass that compacts runs.
__device__ __forceinline__ bool needs_pass(const State& s, float mid,
                                           int strict) {
  return s.compact || (strict ? mid < s.amax : mid <= s.amax);
}

// One bisection step's update of an item's state from this step's
// count `total` (the whole item's). `ctr` is the item's counter of the
// compaction that this step's pass made, if it made one.
__device__ void update_state(State& s, int total, int step, const TopkArgs& a,
                             const int* ctr, int kappa) {
  const float mid = __fmul_rn(0.5f, __fadd_rn(s.lo, s.hi));
  s.w_passes += s.src == 0 && needs_pass(s, mid, a.strict);
  s.fresh = s.compact;
  if (s.compact) {   // the band [lo, hi) of this step's start
    s.src_len = __ldcg(ctr);
    s.src = s.src == 1 ? 2 : 1;
    s.base = s.c_hi;
    if (s.first < 0) s.first = step;
    ++s.events;
    s.compact = 0;
  }
  if ((long long)total >= (long long)kappa + a.off) {
    s.lo = mid;
    s.c_lo = total;
  } else {
    s.hi = mid;
    s.c_hi = total;
  }
  // compact in the next pass if a step follows it to read the band
  const long long band = (long long)s.c_lo - s.c_hi;
  if (step + 2 <= a.iters - 1 && s.events < a.max_events && band <= a.cap &&
      band * kShareDen <= (long long)s.src_len)
    s.compact = 1;
}

__global__ void __launch_bounds__(kThreads)
topk_kernel(TopkArgs a) {
  __shared__ int s_warp[kWarps];
  __shared__ float s_warpf[kWarps];
  __shared__ State s_st[kMaxTracked];
  __shared__ float s_stage[kWarps][kStage + 32];
  __shared__ float s_band[kLocal];
  __shared__ int s_local;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const bool multi = a.n_units > (int)gridDim.x;
  // I <= kMaxTracked: every block keeps every item's state (s_st[item]),
  // so all blocks can agree to finish each item in one block; otherwise
  // a block keeps its own item's (s_st[0]; I > grid: a.st[item])
  const bool tracked = a.n_items <= kMaxTracked;
  const long long n = a.n_items;

  // phase 0: the counts at t, or each item's max |w|
  for (int u = blockIdx.x; u < a.n_units; u += gridDim.x) {
    const long long item = u / a.bpi;
    long long start, end;
    slice_range(a.p, a.bpi, u % a.bpi, &start, &end);
    const float* wi = a.w + item * a.p;
    if (!a.bisect) {
      const float t = a.t[item];
      int c = 0;
      for_range(wi, start, end, a.vec, [&](float x, bool ok) {
        c += ok && above(fabsf(x), t, a.strict);
      });
      c = block_sum(c, s_warp);
      if (tid == 0) atomicAdd(a.tickets + a.n_items + item, c);
    } else {
      float m = 0.f;
      for_range(wi, start, end, a.vec, [&](float x, bool ok) {
        if (ok) m = fmaxf(m, fabsf(x));
      });
      m = block_max(m, s_warpf);
      if (tid == 0) a.part[u] = __float_as_int(m);
    }
  }
  if (!a.bisect) {
    // the single count (one unit a block): the item's last block to
    // finish takes the item's sum and leaves both counters zero
    const long long item = blockIdx.x / a.bpi;
    if (tid == 0) {
      __threadfence();
      if (atomicAdd(a.tickets + item, 1) == a.bpi - 1) {
        a.out[item] = atomicExch(a.tickets + a.n_items + item, 0);
        a.tickets[item] = 0;
      }
    }
    return;
  }
  cg::this_grid().sync();
  for (int u = blockIdx.x; u < a.n_units; u += gridDim.x) {
    const long long item0 = u / a.bpi;
    // warp w initialises item w (tracked) or warp 0 the block's own item
    const int first_item = tracked ? warp : (warp == 0 ? (int)item0 : -1);
    if (first_item < 0 || first_item >= a.n_items || (!tracked && warp))
      continue;
    const float m = warp_max_partials(a.part + first_item * a.bpi, a.bpi);
    if (lane != 0) continue;
    State s;
    s.amax = m;
    s.hi = __fadd_rn(__fmul_rn(m, a.hi_scale), a.hi_add);
    s.lo = 0.f;
    s.c_lo = (int)a.p;
    s.c_hi = 0;
    s.base = 0;
    s.src = 0;
    s.src_len = (int)a.p;
    s.compact = 0;
    s.fresh = 0;
    s.events = 0;
    s.first = -1;
    s.w_passes = 1;
    if (tracked) s_st[first_item] = s;
    else if (multi) a.st[first_item] = s;
    else s_st[0] = s;
  }
  __syncthreads();

  int step = 0;
  for (; step < a.iters; ++step) {
    if (tracked && tid == 0) {
      // every item's band compacted and short: finish in one block each
      // (a grid barrier after the last read of a compaction counter, so
      // that its reset at the end races with no reader)
      int local = 1;
      for (int i = 0; i < a.n_items; ++i)
        local &= s_st[i].src != 0 && s_st[i].src_len <= kLocal &&
                 !s_st[i].compact && !s_st[i].fresh;
      s_local = local;
    }
    __syncthreads();
    if (tracked && s_local) break;
    int* part = a.part + (long long)((step + 1) & 1) * a.n_units;
    for (int u = blockIdx.x; u < a.n_units; u += gridDim.x) {
      const long long item = u / a.bpi;
      __syncthreads();
      const State s = tracked ? s_st[item] : multi ? a.st[item] : s_st[0];
      const float mid = __fmul_rn(0.5f, __fadd_rn(s.lo, s.hi));
      if (!needs_pass(s, mid, a.strict)) continue;
      const float* src = s.src == 0 ? a.w + item * a.p
                                    : a.band + ((s.src - 1) * n + item) * a.cap;
      long long start, end;
      slice_range(s.src == 0 ? a.p : s.src_len, a.bpi, u % a.bpi, &start, &end);
      float* dest = nullptr;
      if (s.compact)
        dest = a.band + ((s.src == 1 ? 1 : 0) * n + item) * a.cap;
      int c = count_pass(src, start, end, s.src == 0 ? a.vec != 0 : true,
                         mid, s, a.strict, dest,
                         a.ctr + item * a.max_events + s.events,
                         s_stage[warp]);
      c = block_sum(c, s_warp);
      if (tid == 0) part[u] = c;
    }
    cg::this_grid().sync();

    // every block sums the partials of each item it keeps and updates it
    if (tracked) {
      for (int i = warp; i < a.n_items; i += kWarps) {
        State s = s_st[i];
        const float mid = __fmul_rn(0.5f, __fadd_rn(s.lo, s.hi));
        const bool pass = needs_pass(s, mid, a.strict);
        const int sum = pass ? warp_sum_partials(part + i * a.bpi, a.bpi) : 0;
        if (lane == 0) {
          update_state(s, s.base * pass + sum, step, a,
                       a.ctr + i * a.max_events + s.events, a.kappa[i]);
          s_st[i] = s;
        }
      }
      __syncthreads();
      continue;
    }
    for (int u = blockIdx.x; u < a.n_units; u += gridDim.x) {
      const long long item = u / a.bpi;
      if (warp != 0) continue;
      State s = multi ? a.st[item] : s_st[0];
      const float mid = __fmul_rn(0.5f, __fadd_rn(s.lo, s.hi));
      const bool pass = needs_pass(s, mid, a.strict);
      const int sum = pass ? warp_sum_partials(part + item * a.bpi, a.bpi) : 0;
      if (lane == 0) {
        update_state(s, s.base * pass + sum, step, a,
                     a.ctr + item * a.max_events + s.events, a.kappa[item]);
        if (multi) a.st[item] = s; else s_st[0] = s;
      }
    }
  }
  __syncthreads();

  // the one-block finish: each item's first block loads the item's band
  // into shared memory and runs the remaining steps alone
  const int local_from = step < a.iters ? step : -1;
  if (step < a.iters) {
    if (blockIdx.x % a.bpi != 0) return;
    const int item = blockIdx.x / a.bpi;
    State s = s_st[item];
    const float* src = a.band + ((long long)(s.src - 1) * n + item) * a.cap;
    for (int e = tid; e < s.src_len; e += kThreads) s_band[e] = __ldcg(src + e);
    __syncthreads();
    for (; step < a.iters; ++step) {
      const float mid = __fmul_rn(0.5f, __fadd_rn(s.lo, s.hi));
      int c = 0;
      for (int e = tid; e < s.src_len; e += kThreads)
        c += above(s_band[e], mid, a.strict);
      const int total = s.base + block_sum(c, s_warp);
      s.compact = 0;
      update_state(s, total, step, a, nullptr, a.kappa[item]);
      s.compact = 0;
    }
    if (tid == 0) s_st[item] = s;
    __syncthreads();
  }

  for (int u = blockIdx.x; u < a.n_units; u += gridDim.x) {
    if (u % a.bpi != 0) continue;
    const long long item = u / a.bpi;
    const State s = tracked ? s_st[item] : multi ? a.st[item] : s_st[0];
    if (tid == 0) {
      a.out[item] = __float_as_int(s.lo);
      a.out[n + item] = __float_as_int(s.hi);
      a.out[2 * n + item] = s.c_hi;
      a.out[3 * n + item] = s.events;
      a.out[4 * n + item] = s.first;
      a.out[5 * n + item] = s.w_passes;
      a.out[6 * n + item] = local_from;
    }
    // every compaction's reader ran before the last grid barrier
    for (int e = tid; e < s.events; e += kThreads)
      a.ctr[item * a.max_events + e] = 0;
  }
}

// Blocks of the kernel that fit on the current card at once, at most
// kMaxBlocksPerSm an SM (0 on an error).
int grid_blocks() {
  int dev = 0, per_sm = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, topk_kernel,
                                                    kThreads, 0) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return (per_sm < kMaxBlocksPerSm ? per_sm : kMaxBlocksPerSm) * sms;
}

long long align16(long long bytes) { return (bytes + 15) / 16 * 16; }

// Band buffer elements an item: a multiple of 4, 0 (no compaction) where
// no step would read a band.
long long band_cap(long long p, int iters) {
  return iters > 2 ? (p / kShareDen + 3) / 4 * 4 : 0;
}

// The bisection's workspace: partials, item states, then the two band
// buffers, each part at a 16-byte boundary.
long long workspace_bytes(long long n_items, long long p, int iters,
                          long long n_units) {
  return align16(2 * n_units * (long long)sizeof(int)) +
         align16(n_items * (long long)sizeof(State)) +
         2 * n_items * band_cap(p, iters) * (long long)sizeof(float);
}

// grid < 1: the single count (a plain launch of I · bpi blocks); else
// the bisection, a cooperative launch of min(I · bpi, grid) blocks.
int run(TopkArgs a, int grid, void* ws, long long ws_bytes, void* stream) {
  if (a.n_items < 1 || a.p < 1 || a.p > 0x7fffffffLL || a.iters < 0 ||
      a.bpi < 1 || (long long)a.n_items * a.bpi > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  a.n_units = a.n_items * a.bpi;
  if (grid >= 1 && a.n_units > grid && a.bpi != 1)
    return (int)cudaErrorInvalidValue;
  a.vec = (a.p % 4 == 0) && (reinterpret_cast<uintptr_t>(a.w) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid < 1) {
    topk_kernel<<<a.n_units, kThreads, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  a.cap = band_cap(a.p, a.iters);
  a.max_events = a.cap > 0 ? a.iters : 0;
  char* base = static_cast<char*>(ws);
  a.part = reinterpret_cast<int*>(base);
  long long off = align16(2LL * a.n_units * (long long)sizeof(int));
  a.st = reinterpret_cast<State*>(base + off);
  off += align16((long long)a.n_items * (long long)sizeof(State));
  a.band = reinterpret_cast<float*>(base + off);
  if (workspace_bytes(a.n_items, a.p, a.iters, a.n_units) > ws_bytes ||
      reinterpret_cast<uintptr_t>(ws) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  void* args[] = {&a};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)topk_kernel, dim3(a.n_units < grid ? a.n_units : grid),
      dim3(kThreads), args, 0, s);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The blocks of the kernel that fit on the current card at once (at most
// kMaxBlocksPerSm an SM): the bisection's largest grid. 0 on an error.
int topk_grid_blocks() { return grid_blocks(); }

// The workspace bytes of a bisection over I · bpi blocks.
long long topk_workspace_bytes(long long n_items, long long p, int iters,
                               int bpi) {
  return workspace_bytes(n_items, p, iters, n_items * bpi);
}

// counts (I,) int32 of |w| > t_i (strict) or |w| >= t_i over `bpi`
// slices an item. `tickets` holds 2 · I zeroed
// ints, left zero. Returns the cudaError_t of the launch (0 on success);
// does not synchronise.
int count_above_batched(const float* w, const float* t, long long n_items,
                        long long p, int strict, int bpi, int* counts,
                        int* tickets, void* stream) {
  TopkArgs a{};
  a.w = w;
  a.t = t;
  a.p = p;
  a.n_items = (int)(n_items > 0x7fffffffLL ? 0 : n_items);
  a.strict = strict;
  a.bpi = bpi;
  a.out = counts;
  a.tickets = tickets;
  return run(a, 0, nullptr, 0, stream);
}

// The bisection: out (7, I) int32 = lo, hi (f32 bits), n_hi, compactions,
// the step of the first one (-1: none), the passes over all of w and the
// first step of the one-block finish (-1: none).
// `ctr` holds I · max(iters, 1) zeroed ints (left zero). `grid` (from
// topk_grid_blocks) bounds the cooperative grid; with I · bpi > grid,
// bpi must be 1. A grid the card cannot place is refused.
int topk_threshold_batched(const float* w, const int* kappa,
                           long long n_items, long long p, int iters,
                           int strict, int bpi, int grid, int* out, int* ctr,
                           void* ws, long long ws_bytes, void* stream) {
  if (grid < 1) return (int)cudaErrorInvalidValue;
  TopkArgs a{};
  a.w = w;
  a.kappa = kappa;
  a.p = p;
  a.n_items = (int)(n_items > 0x7fffffffLL ? 0 : n_items);
  a.iters = iters;
  a.bisect = 1;
  a.strict = strict;
  a.off = strict ? 1 : 0;
  a.hi_scale = strict ? 1.f : 2.f;
  a.hi_add = strict ? 0.f : 1.f;
  a.bpi = bpi;
  a.out = out;
  a.ctr = ctr;
  return run(a, grid, ws, ws_bytes, stream);
}

}  // extern "C"
