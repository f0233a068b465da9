// K1: the dual active-set bulk phase, one thread per lane, whole loop in
// the kernel.
//
// Replaces linearmpc_tpu/ops/pallas_solver.py::_iteration_kernel (driven
// there by phase1_pallas / phase1_pallas_while, one gridless call per
// iteration with the loop outside). Here each thread owns one lane and runs
// its iterations until the lane converges or reaches max_iter, so the
// per-lane early exit of the while-variant and the fixed scan of
// phase1_pallas give the same result.
//
// Per iteration and lane: gather the working-set inverse inv = table[act]
// (bit i of the mask id is row i, table laid out (2^m, m, m) row-major),
// lam* = inv @ (-act * d_side), then either the blocking step (first
// multiplier to cross zero leaves the set) or the acceptance step (the
// most violated inactive row, by the slack G @ lam*, enters).
//
// What bounds it: latency. An iteration is a few hundred flops per lane on
// data that lives in registers (lam, bounds, masks) plus one dependent
// gather of m*m table entries. The design keeps the state in registers
// (act/side are bitmasks, loops unrolled by the template on M), stages the
// table and G in shared memory when they fit in a block's 227 KB, and
// otherwise reads the table through L1/L2 (f32 at m=10 is 400 KB, f64 at
// m=9 is 332 KB). No TPU workaround is carried over: the gather is a load,
// first-index ties are a scan, and any B is taken with the edge masked.
//
// The float instantiation is the bulk phase of the small-m tier; the double
// instantiation is the f64 straggler continuation (finish_from_state).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr size_t kSmemLimit = 227 * 1024;

template <typename T> struct Sentinel;
template <> struct Sentinel<float> { static __device__ float big() { return 3.0e38f; } };
template <> struct Sentinel<double> { static __device__ double big() { return 1.0e30; } };

template <typename T, int M>
__global__ void __launch_bounds__(kThreads) phase1_kernel(
    const T* __restrict__ subset, const T* __restrict__ G,
    const T* __restrict__ du_t, const T* __restrict__ dl_t,
    const T* __restrict__ lam0, const uint8_t* __restrict__ act0,
    const uint8_t* __restrict__ side0,
    T* __restrict__ lam_o, uint8_t* __restrict__ act_o, uint8_t* __restrict__ side_o,
    int32_t* __restrict__ iters_o, uint8_t* __restrict__ done_o,
    int B, unsigned eq_mask, unsigned immut_mask, int max_iter, T ptol, T stol,
    int table_in_smem) {
  constexpr int MM = M * M;
  constexpr int n_tab = (1 << M) * MM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  // G always, the subset table when it fits
  T* Gs = smem;
  for (int i = threadIdx.x; i < MM; i += blockDim.x) Gs[i] = G[i];
  const T* tab = subset;
  if (table_in_smem) {
    T* ts = smem + MM;
    for (int i = threadIdx.x; i < n_tab; i += blockDim.x) ts[i] = subset[i];
    tab = ts;
  }
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  const T big = Sentinel<T>::big();
  const T tiny = T(1e-30);
  T du[M], dl[M], lam[M];
  unsigned act = 0, side = 0;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const size_t o = static_cast<size_t>(b) * M + i;
    du[i] = du_t[o];
    dl[i] = dl_t[o];
    lam[i] = lam0[o];
    act |= (act0[o] ? 1u : 0u) << i;
    side |= (side0[o] ? 1u : 0u) << i;
  }

  int iters = 0;
  bool done = false;
  for (int it = 0; it < max_iter && !done; ++it) {
    ++iters;
    const T* inv = tab + static_cast<size_t>(act) * MM;
    T rhs[M];
#pragma unroll
    for (int k = 0; k < M; ++k)
      rhs[k] = ((act >> k) & 1u) ? -(((side >> k) & 1u) ? du[k] : dl[k]) : T(0);
    T ls[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      T s = inv[i * M] * rhs[0];
#pragma unroll
      for (int k = 1; k < M; ++k) s += inv[i * M + k] * rhs[k];
      ls[i] = s;
    }

    // removable active rows whose multiplier has the wrong sign
    bool hv = false;
    T amin = big;
    int jb = 0;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const bool rem = ((act >> i) & 1u) && !((eq_mask >> i) & 1u);
      const bool up = (side >> i) & 1u;
      const bool sv = rem && (up ? ls[i] < -stol : ls[i] > stol);
      T a = big;
      if (sv) {
        hv = true;
        const T den = lam[i] - ls[i];
        const T safe = fabs(den) > tiny ? den : tiny;
        a = lam[i] / safe;
      }
      if (i == 0 || a < amin) {  // argmin, lowest index on ties
        amin = a;
        jb = i;
      }
    }

    if (hv) {
      // blocking step: move toward lam*, the first multiplier to cross
      // zero leaves the working set
      const T alpha = fmin(fmax(amin, T(0)), T(1));
#pragma unroll
      for (int i = 0; i < M; ++i)
        lam[i] = (i == jb) ? T(0) : lam[i] + alpha * (ls[i] - lam[i]);
      act &= ~(1u << jb);
    } else {
      // acceptance step: take lam*, add the most violated inactive row
      T vmax = -big;
      int j = 0;
      bool up_j = true;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        T c = Gs[i * M] * ls[0];
#pragma unroll
        for (int k = 1; k < M; ++k) c += Gs[i * M + k] * ls[k];
        const bool cand = !((act >> i) & 1u) && !((immut_mask >> i) & 1u);
        const T vup = cand ? -(du[i] + c) : -big;
        const T vlo = cand ? dl[i] + c : -big;
        const T v = vup > vlo ? vup : vlo;
        if (i == 0 || v > vmax) {  // argmax, lowest index on ties
          vmax = v;
          j = i;
          up_j = vup >= vlo;
        }
      }
      const bool conv = vmax <= ptol;
      if (!conv) {
        act |= 1u << j;
        side = up_j ? (side | (1u << j)) : (side & ~(1u << j));
      }
#pragma unroll
      for (int i = 0; i < M; ++i) lam[i] = ((act >> i) & 1u) ? ls[i] : T(0);
      done = conv;
    }
  }

#pragma unroll
  for (int i = 0; i < M; ++i) {
    const size_t o = static_cast<size_t>(b) * M + i;
    lam_o[o] = lam[i];
    act_o[o] = (act >> i) & 1u;
    side_o[o] = (side >> i) & 1u;
  }
  iters_o[b] = iters;
  done_o[b] = done;
}

template <typename T, int M>
cudaError_t launch(const void* subset, const void* G, const void* du, const void* dl,
                   const void* lam0, const void* act0, const void* side0, void* lam,
                   void* act, void* side, void* iters, void* done, int B,
                   unsigned eq_mask, unsigned immut_mask, int max_iter, double ptol,
                   double stol, cudaStream_t stream) {
  const size_t g_bytes = sizeof(T) * M * M;
  const size_t tab_bytes = sizeof(T) * (size_t(1) << M) * M * M;
  const int table_in_smem = g_bytes + tab_bytes <= kSmemLimit;
  const size_t smem = g_bytes + (table_in_smem ? tab_bytes : 0);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        phase1_kernel<T, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int grid = (B + kThreads - 1) / kThreads;
  phase1_kernel<T, M><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(subset), static_cast<const T*>(G),
      static_cast<const T*>(du), static_cast<const T*>(dl),
      static_cast<const T*>(lam0), static_cast<const uint8_t*>(act0),
      static_cast<const uint8_t*>(side0), static_cast<T*>(lam),
      static_cast<uint8_t*>(act), static_cast<uint8_t*>(side),
      static_cast<int32_t*>(iters), static_cast<uint8_t*>(done), B, eq_mask,
      immut_mask, max_iter, static_cast<T>(ptol), static_cast<T>(stol), table_in_smem);
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

// dtype: 0 = float32, 1 = float64. All arrays batch-major (B, m), bool
// arrays as one byte per entry. Returns the cudaError_t of the launch.
extern "C" int lmpc_phase1(int dtype, int m, const void* subset, const void* G,
                           const void* du, const void* dl, const void* lam0,
                           const void* act0, const void* side0, void* lam, void* act,
                           void* side, void* iters, void* done, int B,
                           unsigned eq_mask, unsigned immut_mask, int max_iter,
                           double ptol, double stol, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(m, subset, G, du, dl, lam0, act0, side0, lam, act, side,
                           iters, done, B, eq_mask, immut_mask, max_iter, ptol, stol, s);
  if (dtype == 1)
    return dispatch<double>(m, subset, G, du, dl, lam0, act0, side0, lam, act, side,
                            iters, done, B, eq_mask, immut_mask, max_iter, ptol, stol, s);
  return cudaErrorInvalidValue;
}
