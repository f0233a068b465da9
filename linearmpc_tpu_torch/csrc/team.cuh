// Helpers of the small-m kernels K1 (bulk.cu) and K2 (polish.cu), where a
// team of T = 4, 8 or 16 threads of one warp runs one lane: the team's
// shuffle mask, its ballot as a bit set over the team's threads, exact
// arg- and max-reductions across the team, and cp.async staging of static
// arrays into shared memory.
#pragma once

#include "gi_common.cuh"

namespace team {

// The calling thread's team within its warp (T a power of two <= 32).
template <int T>
__device__ __forceinline__ int base() {
  return (threadIdx.x & 31) & ~(T - 1);
}
template <int T>
__device__ __forceinline__ unsigned mask() {
  return T == 32 ? gi::kFull : (((1u << T) - 1u) << base<T>());
}

// Bit t set where thread t of the team passed a true flag.
template <int T>
__device__ __forceinline__ unsigned ballot(unsigned tmask, bool p) {
  const unsigned bits = __ballot_sync(tmask, p) >> base<T>();
  return T == 32 ? bits : bits & ((1u << T) - 1u);
}

// A value's place in torch's arg-reduction order as an unsigned key:
// ascending with the value, -0 and +0 one key (a tie), a NaN the smallest
// key for an arg-min and the largest for an arg-max (the first NaN wins).
__device__ __forceinline__ unsigned order_key(float v, bool is_min) {
  if (isnan(v)) return is_min ? 0u : ~0u;
  const unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u >> 31) ? ~u : (u | (1u << 31));
}
__device__ __forceinline__ unsigned long long order_key(double v, bool is_min) {
  if (isnan(v)) return is_min ? 0ull : ~0ull;
  const unsigned long long u = __double_as_longlong(v == 0.0 ? 0.0 : v);
  return (u >> 63) ? ~u : (u | (1ull << 63));
}

__device__ __forceinline__ unsigned reduce(unsigned tmask, bool is_min, unsigned k) {
  return is_min ? __reduce_min_sync(tmask, k) : __reduce_max_sync(tmask, k);
}

// First-hit arg-reduction over the team, as torch's argmin / argmax: the
// team's best key by redux.sync (a double's high word, then its low word
// among the threads that hold the best high word), then the lowest thread
// holding it by a ballot. Thread t holds row t, so that is the lowest row
// on ties; a thread without a row passes valid = false and never wins (no
// value's key is the all-ones or all-zeros word it passes). Returns the
// winning row; `best` is its key, the same in every thread.
template <int T>
__device__ __forceinline__ int arg(unsigned tmask, bool is_min, float v, bool valid,
                                   unsigned& best) {
  const unsigned k = valid ? order_key(v, is_min) : (is_min ? ~0u : 0u);
  best = reduce(tmask, is_min, k);
  return __ffs(ballot<T>(tmask, k == best)) - 1;
}
template <int T>
__device__ __forceinline__ int arg(unsigned tmask, bool is_min, double v, bool valid,
                                   unsigned long long& best) {
  const unsigned long long k = valid ? order_key(v, is_min) : (is_min ? ~0ull : 0ull);
  const unsigned hi = static_cast<unsigned>(k >> 32), lo = static_cast<unsigned>(k);
  const unsigned best_hi = reduce(tmask, is_min, hi);
  // every thread of the team takes part in each reduction
  const unsigned best_lo = reduce(tmask, is_min, hi == best_hi ? lo : (is_min ? ~0u : 0u));
  best = (static_cast<unsigned long long>(best_hi) << 32) | best_lo;
  return __ffs(ballot<T>(tmask, k == best)) - 1;
}

// The team's maximum with torch's NaN rule (amax passes a NaN on).
template <int T, typename V>
__device__ __forceinline__ V max(unsigned tmask, V v) {
#pragma unroll
  for (int o = T / 2; o > 0; o >>= 1) v = gi::nan_max(v, __shfl_xor_sync(tmask, v, o, T));
  return v;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy `bytes` (a multiple of E = 4 or 8) from global to shared memory with
// cp.async, the block's threads tid = 0 .. nt-1 each taking every nt-th
// chunk: 16-byte chunks where both ends are 16-byte aligned, E-byte chunks
// for the rest. The caller commits and waits (wait_all) and then syncs.
template <int E>
__device__ __forceinline__ void stage(void* dst, const void* src, size_t bytes, int tid, int nt) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  size_t head = 0;
  if (gi::aligned16(d) && gi::aligned16(s)) {
    head = bytes & ~size_t(15);
    for (size_t o = 16 * size_t(tid); o < head; o += 16 * size_t(nt))
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(d + o)),
                   "l"(s + o));
  }
  for (size_t o = head + E * size_t(tid); o < bytes; o += E * size_t(nt)) {
    if constexpr (E == 8) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(d + o)),
                   "l"(s + o));
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(d + o)),
                   "l"(s + o));
    }
  }
}

__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

}  // namespace team
