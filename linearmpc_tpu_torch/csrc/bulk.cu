// K1: the dual active-set bulk phase, a team of T threads per lane, whole
// early-exit loop in the kernel.
//
// Replaces linearmpc_tpu/ops/pallas_solver.py::_iteration_kernel (driven
// there by phase1_pallas / phase1_pallas_while, one gridless call per
// iteration with the loop outside). Here a team runs one lane's iterations
// until the lane converges or reaches max_iter, so the per-lane early exit
// of the while-variant and the fixed scan of phase1_pallas give the same
// result.
//
// Per iteration and lane: gather the working-set inverse inv = table[act]
// (bit i of the mask id is row i, table laid out (2^m, m, m) row-major),
// lam* = inv @ (-act * d_side), then either the blocking step (first
// multiplier to cross zero leaves the set) or the acceptance step (the
// most violated inactive row, by the slack G @ lam*, enters).
//
// What bounds it: latency. An iteration is a few hundred flops per lane on
// data that lives in registers plus one dependent gather of m*m table
// entries, and a launch lasts as long as its longest lane (the cold batch
// holds every lane at once; none comes near the cap). The design:
//  * a team of T = 4 (m <= 4), 8 (m <= 8) or 16 threads runs a lane, thread
//    i owning row i: lam_i and row i of G stay in its registers, act and
//    side are team-uniform bit masks, and every thread holds the lane's
//    bounds, so it forms the right side itself;
//  * per iteration thread i sums row i of inv[act] against it (k = 0 ..
//    m-1, the order of ordered_matvec), a vote tells whether any multiplier
//    has the wrong sign, and the blocking arg-min and the acceptance
//    arg-max are one redux.sync and one ballot each, with torch's tie and
//    NaN rules (team.cuh; convergence is read off the arg-max's key); lam*
//    reaches the team by m shuffles for the slack G @ lam*;
//  * a subset table of at most kTableSmem bytes (f32 m <= 6, f64 m <= 5) is
//    staged per block in shared memory, its copy in flight while the
//    lanes' inputs load; a larger one is read through L1/L2, which measured
//    faster at m = 8 and 9, where the staged table costs blocks per SM
//    (PERF.md, K1);
//  * blocks of 128 threads, one lane per team, as many as the batch needs.
// No TPU workaround is carried over: the gather is a load and any B is
// taken with the edge masked.
//
// The float instantiation is the bulk phase of the small-m tier and the
// warm rollout step; the double instantiation is the f64 straggler
// continuation (finish_from_state).

#include <cuda_runtime.h>
#include <stdint.h>

#include "team.cuh"

namespace {

constexpr int kThreads = 128;
constexpr size_t kTableSmem = 16 * 1024;  // the largest table staged in shared memory

template <typename T> struct Sentinel;
template <> struct Sentinel<float> { static __device__ float big() { return 3.0e38f; } };
template <> struct Sentinel<double> { static __device__ double big() { return 1.0e30; } };

template <int M>
__host__ __device__ constexpr int team_size() {
  return M <= 4 ? 4 : (M <= 8 ? 8 : 16);
}

template <typename T, int M>
__host__ __device__ constexpr size_t table_bytes() {
  return sizeof(T) * (size_t(1) << M) * M * M;
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads) phase1_kernel(
    const T* __restrict__ subset, const T* __restrict__ G,
    const T* __restrict__ du_t, const T* __restrict__ dl_t,
    const T* __restrict__ lam0, const uint8_t* __restrict__ act0,
    const uint8_t* __restrict__ side0,
    T* __restrict__ lam_o, uint8_t* __restrict__ act_o, uint8_t* __restrict__ side_o,
    int32_t* __restrict__ iters_o, uint8_t* __restrict__ done_o,
    int B, unsigned eq_mask, unsigned immut_mask, int max_iter, T ptol, T stol) {
  constexpr int TS = team_size<M>();
  constexpr int MM = M * M;
  constexpr bool table_in_smem = table_bytes<T, M>() <= kTableSmem;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the table's copy into shared memory is in flight while the lane's
  // inputs load
  if constexpr (table_in_smem)
    team::stage<sizeof(T)>(smem_raw, subset, table_bytes<T, M>(), threadIdx.x, kThreads);
  const T* tab = table_in_smem ? reinterpret_cast<const T*>(smem_raw) : subset;
  const int b = blockIdx.x * (kThreads / TS) + threadIdx.x / TS;
  const bool live = b < B;
  const int t = threadIdx.x % TS;
  const bool row = t < M;
  const unsigned tmask = team::mask<TS>();
  const T big = Sentinel<T>::big();
  const T tiny = T(1e-30);
  const bool eq_t = (eq_mask >> t) & 1u, immut_t = (immut_mask >> t) & 1u;

  // every thread holds the lane's bounds (rhs needs no exchange) and its
  // row of G; thread t < m holds lam_t
  T du[M], dl[M], g[M];
  const size_t o = static_cast<size_t>(b) * M + t;
  T lam = T(0), du_i = T(0), dl_i = T(0);
  bool a_in = false, s_in = false;
  if (live) {
#pragma unroll
    for (int k = 0; k < M; ++k) {
      du[k] = du_t[static_cast<size_t>(b) * M + k];
      dl[k] = dl_t[static_cast<size_t>(b) * M + k];
      g[k] = row ? G[t * M + k] : T(0);
    }
    if (row) {
      lam = lam0[o];
      du_i = du_t[o];
      dl_i = dl_t[o];
      a_in = act0[o];
      s_in = side0[o];
    }
  }
  if constexpr (table_in_smem) {
    team::wait_all();
    __syncthreads();
  }
  if (!live) return;  // a whole team leaves; no block barrier follows
  unsigned act = team::ballot<TS>(tmask, a_in);
  unsigned side = team::ballot<TS>(tmask, s_in);
  auto ptol_key = team::order_key(ptol, false);  // the arg-max key of ptol

  int iters = 0;
  bool done = false;
  for (int it = 0; it < max_iter && !done; ++it) {
    ++iters;
    T r[M];
#pragma unroll
    for (int k = 0; k < M; ++k)
      r[k] = ((act >> k) & 1u) ? -(((side >> k) & 1u) ? du[k] : dl[k]) : T(0);
    // lam* = inv[act] @ rhs, row t
    T ls = T(0);
    if (row) {
      const T* inv = tab + static_cast<size_t>(act) * MM + t * M;
      T s = inv[0] * r[0];
#pragma unroll
      for (int k = 1; k < M; ++k) s = s + inv[k] * r[k];
      ls = s;
    }

    // removable active rows whose multiplier has the wrong sign
    const bool a = (act >> t) & 1u, up = (side >> t) & 1u;
    const bool sv = row && a && !eq_t && (up ? ls < -stol : ls > stol);
    if (__any_sync(tmask, sv)) {
      // blocking step: move toward lam*, the first multiplier to cross
      // zero leaves the working set
      T av = big;
      if (sv) {
        const T den = lam - ls;
        av = lam / (fabs(den) > tiny ? den : tiny);
      }
      decltype(ptol_key) best;
      const int jb = team::arg<TS>(tmask, true, av, row, best);
      const T amin = __shfl_sync(tmask, av, jb, TS);
      const T alpha = gi::nan_min(gi::nan_max(amin, T(0)), T(1));
      if (row) lam = (t == jb) ? T(0) : lam + alpha * (ls - lam);
      act &= ~(1u << jb);
    } else {
      // acceptance step: take lam*, add the most violated inactive row
      T l[M];
#pragma unroll
      for (int k = 0; k < M; ++k) l[k] = __shfl_sync(tmask, ls, k, TS);
      T v = -big;
      bool up_t = false;
      if (row) {
        T c = g[0] * l[0];
#pragma unroll
        for (int k = 1; k < M; ++k) c = c + g[k] * l[k];
        const bool cand = !a && !immut_t;
        const T vup = cand ? -(du_i + c) : -big;
        const T vlo = cand ? dl_i + c : -big;
        v = gi::nan_max(vup, vlo);
        up_t = vup >= vlo;
      }
      decltype(ptol_key) best;
      const int j = team::arg<TS>(tmask, false, v, row, best);
      const unsigned ups = team::ballot<TS>(tmask, up_t);
      // converged when the most violated row is within tolerance (a NaN
      // wins the arg-max with the largest key and fails the test)
      done = best <= ptol_key;
      if (!done) {
        act |= 1u << j;
        side = ((ups >> j) & 1u) ? (side | (1u << j)) : (side & ~(1u << j));
      }
      if (row) lam = ((act >> t) & 1u) ? ls : T(0);
    }
  }

  if (row) {
    lam_o[o] = lam;
    act_o[o] = (act >> t) & 1u;
    side_o[o] = (side >> t) & 1u;
  }
  if (t == 0) {
    iters_o[b] = iters;
    done_o[b] = done;
  }
}

template <typename T, int M>
cudaError_t launch(const void* subset, const void* G, const void* du, const void* dl,
                   const void* lam0, const void* act0, const void* side0, void* lam,
                   void* act, void* side, void* iters, void* done, int B,
                   unsigned eq_mask, unsigned immut_mask, int max_iter, double ptol,
                   double stol, cudaStream_t stream) {
  constexpr int L = kThreads / team_size<M>();
  constexpr size_t smem = table_bytes<T, M>() <= kTableSmem ? table_bytes<T, M>() : 0;
  phase1_kernel<T, M><<<(B + L - 1) / L, kThreads, smem, stream>>>(
      static_cast<const T*>(subset), static_cast<const T*>(G),
      static_cast<const T*>(du), static_cast<const T*>(dl),
      static_cast<const T*>(lam0), static_cast<const uint8_t*>(act0),
      static_cast<const uint8_t*>(side0), static_cast<T*>(lam),
      static_cast<uint8_t*>(act), static_cast<uint8_t*>(side),
      static_cast<int32_t*>(iters), static_cast<uint8_t*>(done), B, eq_mask,
      immut_mask, max_iter, static_cast<T>(ptol), static_cast<T>(stol));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int m, const void* subset, const void* G, const void* du,
                     const void* dl, const void* lam0, const void* act0,
                     const void* side0, void* lam, void* act, void* side, void* iters,
                     void* done, int B, unsigned eq_mask, unsigned immut_mask,
                     int max_iter, double ptol, double stol, cudaStream_t s) {
#define LMPC_CASE(MV)                                                              \
  case MV:                                                                         \
    return launch<T, MV>(subset, G, du, dl, lam0, act0, side0, lam, act, side,     \
                         iters, done, B, eq_mask, immut_mask, max_iter, ptol, stol, s);
  switch (m) {
    LMPC_CASE(1) LMPC_CASE(2) LMPC_CASE(3) LMPC_CASE(4) LMPC_CASE(5)
    LMPC_CASE(6) LMPC_CASE(7) LMPC_CASE(8) LMPC_CASE(9) LMPC_CASE(10)
    default:
      return cudaErrorInvalidValue;
  }
#undef LMPC_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = float64. All arrays batch-major (B, m) and
// contiguous, bool arrays as one byte per entry. Returns the cudaError_t of
// the launch.
extern "C" int lmpc_phase1(int dtype, int m, const void* subset, const void* G,
                           const void* du, const void* dl, const void* lam0,
                           const void* act0, const void* side0, void* lam, void* act,
                           void* side, void* iters, void* done, int B,
                           unsigned eq_mask, unsigned immut_mask, int max_iter,
                           double ptol, double stol, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1) return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(m, subset, G, du, dl, lam0, act0, side0, lam, act, side,
                           iters, done, B, eq_mask, immut_mask, max_iter, ptol, stol, s);
  if (dtype == 1)
    return dispatch<double>(m, subset, G, du, dl, lam0, act0, side0, lam, act, side,
                            iters, done, B, eq_mask, immut_mask, max_iter, ptol, stol, s);
  return cudaErrorInvalidValue;
}
