// Batched threshold mask: keep the weights whose magnitude clears a
// per-item threshold.
//
// Replaces the TPU kernels
//   src/repro/kernels/prune/prune.py:mask_apply_batched (K3, body
//   _mask_batched_kernel) and prune.py:mask_apply (K9, body _mask_kernel;
//   its single-vector strict form is this kernel's I = 1 launch through
//   the entry point mask_apply_single).
//
// For a packed group w (I, P) f32 and per-item thresholds t (I,) f32:
//   out[i, p] = |w[i, p]| >  t[i] ? w[i, p] : 0   (strict)
//   out[i, p] = |w[i, p]| >= t[i] ? w[i, p] : 0   (not strict)
// exactly jnp.where(keep, w, 0.0): the kept weights pass bit for bit.
//
// Bound on the H100: 8 B per element (read w once, write out once) and
// one compare, so the kernel is memory-bound (8 B/element over
// 3.35 TB/s). Each thread moves one float4 (16-byte loads and stores,
// neighbouring threads on neighbouring addresses); the grid is
// (vector tiles, items). A row starts 16-byte aligned only when P is a
// multiple of 4, so each row is split into a head of up to 3 elements
// before its first 16-byte boundary, a float4 body, and a tail of up to
// 3 elements; block 0 of each row does the head and the tail with scalar
// accesses. Nothing is padded.
//
// K9 at the single-vector size of its path (P = 266,200: ~2 MB, well under
// a microsecond of memory traffic) is bound by its launch, not by bytes:
// mask_apply_single takes the vector and a device pointer to its 0-d
// threshold (or the threshold by value), so the wrapper adds no view, no
// threshold tensor and no batch checks before the launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;               // one float4 per thread

__device__ __forceinline__ float keep(float x, float t, int strict) {
  const float a = fabsf(x);
  return (strict ? (a > t) : (a >= t)) ? x : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
mask_apply_kernel(const float* __restrict__ w, const float* __restrict__ t,
                  float t_value, int64_t p, int strict,
                  float* __restrict__ out) {
  const int64_t item = blockIdx.y;
  const float ti = t != nullptr ? t[item] : t_value;
  const float* wi = w + item * p;
  float* oi = out + item * p;
  // w and out share their alignment (checked by the wrapper), so one head
  // length serves both
  const int64_t head_len = (int64_t)((16u - ((uintptr_t)wi & 15u)) & 15u) >> 2;
  const int64_t head = head_len < p ? head_len : p;
  const int64_t n_vec = (p - head) >> 2;
  const int64_t v = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (v < n_vec) {
    const float4 x = reinterpret_cast<const float4*>(wi + head)[v];
    float4 y;
    y.x = keep(x.x, ti, strict);
    y.y = keep(x.y, ti, strict);
    y.z = keep(x.z, ti, strict);
    y.w = keep(x.w, ti, strict);
    reinterpret_cast<float4*>(oi + head)[v] = y;
  }
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    // threads 0-3: the head elements; threads 4-7: the tail elements
    const int64_t e = threadIdx.x < 4 ? (int64_t)threadIdx.x
                                      : head + 4 * n_vec + (threadIdx.x - 4);
    const bool live = threadIdx.x < 4 ? e < head : e < p;
    if (live) oi[e] = keep(wi[e], ti, strict);
  }
}

int launch(const float* w, const float* t, float t_value, long long n_items,
           long long p, int strict, float* out, void* stream) {
  if (n_items < 1 || n_items > 65535 || p < 1)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)w & 15u) != ((uintptr_t)out & 15u) ||
      ((uintptr_t)w & 3u) != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long n_vec = p >> 2;           // an upper bound for every row
  long long n_blocks = (n_vec + kThreads - 1) / kThreads;
  if (n_blocks < 1) n_blocks = 1;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  mask_apply_kernel<<<dim3((unsigned)n_blocks, (unsigned)n_items), kThreads,
                      0, static_cast<cudaStream_t>(stream)>>>(
      w, t, t_value, p, strict, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Both entry points launch on `stream` and return the cudaError_t of the
// launch (0 on success); neither synchronises. `w` and `out` must have the
// same address modulo 16 bytes.

// K3: w (I, P), per-item thresholds t (I,).
int mask_apply_batched(const float* w, const float* t, long long n_items,
                       long long p, int strict, float* out, void* stream) {
  if (t == nullptr) return (int)cudaErrorInvalidValue;
  return launch(w, t, 0.0f, n_items, p, strict, out, stream);
}

// K9: w (P,), strict, the threshold at device address `t`, or `t_value`
// when `t` is null.
int mask_apply_single(const float* w, const float* t, float t_value,
                      long long p, float* out, void* stream) {
  return launch(w, t, t_value, 1, p, 1, out, stream);
}

}  // extern "C"
