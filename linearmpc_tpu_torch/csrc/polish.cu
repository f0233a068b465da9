// K2: polish of each lane's final working set, one thread per lane, native
// float64.
//
// Replaces linearmpc_tpu/ops/pallas_polish.py::_polish_kernel (driven there
// by polish_pallas), which carried the computation in double-single f32 to
// about 2^-48 relative because the TPU has no f64. The H100 has hardware
// f64, so this kernel computes the same quantities in plain double, which
// meets and beats that accuracy contract:
//   d = d0 + Dth theta;  lam = inv[act] @ (-act * d_side);
//   U = u_off + Uth theta - HinvET lam;  fval = 0.5 U'HU + (f + fth theta)'U;
//   bad = max(primal violation of inactive rows,
//             sign violation of removable active rows)
// with -big (big = 3e38) for a lane that has neither (as pallas_polish.py
// :241-254).
//
// What bounds it: f64 arithmetic per lane, O(m^2 + n*(m + n + nth)) flops,
// run once per solve. The small static matrices are read through the
// read-only data cache (const __restrict__); the f64 subset table (800 KB
// at m=10) stays in global memory and L2. U is written to its output row
// and read back by the same thread for the objective, so n and nth need no
// compile-time bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <int M>
__global__ void __launch_bounds__(kThreads) polish_kernel(
    const double* __restrict__ subset, const double* __restrict__ G,
    const double* __restrict__ Dth, const double* __restrict__ du0,
    const double* __restrict__ dl0, const double* __restrict__ HET,
    const double* __restrict__ Uth, const double* __restrict__ uoff,
    const double* __restrict__ H, const double* __restrict__ f,
    const double* __restrict__ fth, const double* __restrict__ theta,
    const uint8_t* __restrict__ act_in, const uint8_t* __restrict__ side_in,
    double* U_o, double* __restrict__ lam_o, double* __restrict__ fval_o,
    double* __restrict__ bad_o, int B, int n, int nth, unsigned eq_mask,
    unsigned immut_mask) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const double big = 3.0e38;
  const double* th = theta + static_cast<size_t>(b) * nth;

  unsigned act = 0, side = 0;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const size_t o = static_cast<size_t>(b) * M + i;
    act |= (act_in[o] ? 1u : 0u) << i;
    side |= (side_in[o] ? 1u : 0u) << i;
  }

  // transformed bounds d = d0 + Dth theta
  double du[M], dl[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    double dt = 0.0;
    for (int j = 0; j < nth; ++j) dt += Dth[i * nth + j] * th[j];
    du[i] = du0[i] + dt;
    dl[i] = dl0[i] + dt;
  }

  // working-set KKT solve through the gathered inverse
  double rhs[M];
#pragma unroll
  for (int k = 0; k < M; ++k)
    rhs[k] = ((act >> k) & 1u) ? -(((side >> k) & 1u) ? du[k] : dl[k]) : 0.0;
  const double* inv = subset + static_cast<size_t>(act) * M * M;
  double lam[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    double s = inv[i * M] * rhs[0];
#pragma unroll
    for (int k = 1; k < M; ++k) s += inv[i * M + k] * rhs[k];
    lam[i] = s;
  }

  // primal recovery U = u_off + Uth theta - HinvET lam
  double* U = U_o + static_cast<size_t>(b) * n;
  for (int r = 0; r < n; ++r) {
    double ut = 0.0;
    for (int j = 0; j < nth; ++j) ut += Uth[r * nth + j] * th[j];
    double hl = 0.0;
#pragma unroll
    for (int k = 0; k < M; ++k) hl += HET[r * M + k] * lam[k];
    U[r] = (uoff[r] + ut) - hl;
  }

  // objective 0.5 U'(H U) + (f + fth theta)'U
  double quad = 0.0, lin = 0.0;
  for (int i = 0; i < n; ++i) {
    double hu = 0.0;
    for (int j = 0; j < n; ++j) hu += H[i * n + j] * U[j];
    double ft = 0.0;
    for (int j = 0; j < nth; ++j) ft += fth[i * nth + j] * th[j];
    ft = f[i] + ft;
    quad += U[i] * hu;
    lin += ft * U[i];
  }

  // KKT residual
  double primal = -big, sgn = -big;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    double c = G[i * M] * lam[0];
#pragma unroll
    for (int k = 1; k < M; ++k) c += G[i * M + k] * lam[k];
    const bool a = (act >> i) & 1u;
    if (!a && !((immut_mask >> i) & 1u)) {
      const double vup = -(du[i] + c), vlo = dl[i] + c;
      primal = fmax(primal, vup > vlo ? vup : vlo);
    }
    if (a && !((eq_mask >> i) & 1u))
      sgn = fmax(sgn, ((side >> i) & 1u) ? -lam[i] : lam[i]);
    lam_o[static_cast<size_t>(b) * M + i] = lam[i];
  }
  fval_o[b] = 0.5 * quad + lin;
  bad_o[b] = fmax(primal, sgn);
}

}  // namespace

// All arrays float64 row-major, bool arrays one byte per entry; theta (B,
// nth), act/side (B, m); outputs U (B, n), lam (B, m), fval (B), bad (B).
// Returns the cudaError_t of the launch.
extern "C" int lmpc_polish(int m, const void* subset, const void* G, const void* Dth,
                           const void* du, const void* dl, const void* HET,
                           const void* Uth, const void* uoff, const void* H,
                           const void* f, const void* fth, const void* theta,
                           const void* act, const void* side, void* U, void* lam,
                           void* fval, void* bad, int B, int n, int nth,
                           unsigned eq_mask, unsigned immut_mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (B + kThreads - 1) / kThreads;
#define LMPC_CASE(MV)                                                               \
  case MV:                                                                          \
    polish_kernel<MV><<<grid, kThreads, 0, s>>>(                                    \
        static_cast<const double*>(subset), static_cast<const double*>(G),          \
        static_cast<const double*>(Dth), static_cast<const double*>(du),            \
        static_cast<const double*>(dl), static_cast<const double*>(HET),            \
        static_cast<const double*>(Uth), static_cast<const double*>(uoff),          \
        static_cast<const double*>(H), static_cast<const double*>(f),               \
        static_cast<const double*>(fth), static_cast<const double*>(theta),         \
        static_cast<const uint8_t*>(act), static_cast<const uint8_t*>(side),        \
        static_cast<double*>(U), static_cast<double*>(lam),                         \
        static_cast<double*>(fval), static_cast<double*>(bad), B, n, nth, eq_mask,  \
        immut_mask);                                                                \
    break;
  switch (m) {
    LMPC_CASE(1) LMPC_CASE(2) LMPC_CASE(3) LMPC_CASE(4) LMPC_CASE(5)
    LMPC_CASE(6) LMPC_CASE(7) LMPC_CASE(8) LMPC_CASE(9) LMPC_CASE(10)
    default:
      return cudaErrorInvalidValue;
  }
#undef LMPC_CASE
  return cudaGetLastError();
}
