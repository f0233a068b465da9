// K2: polish of each lane's final working set in native float64, a team of
// T threads per lane.
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
// What bounds it: one lane is a short chain of f64 dot products
// (O(m^2 + n (m + n + nth)) flops), run once per solve, so a launch is the
// latency of that chain plus its loads; the bytes (theta, the masks, the
// outputs) are a fraction of a microsecond at the rollout's 4096 lanes. The
// design shortens the chain and fills the card:
//  * a team of T threads runs a lane (T the smallest power of two >=
//    max(m, n), at least 4 and at most 16), so a block of 128 threads holds
//    128 / T lanes: 4096 lanes are 256 blocks at T = 8. Thread t owns rows
//    t, t + T, ... of every m- and n-space vector; rhs and lam reach the team
//    by width-T shuffles, the rows of U through the lane's shared memory;
//  * the static arrays, packed into one float64 buffer by ops/polish.py,
//    are staged once per block with cp.async, beside the block's theta rows
//    (16-byte chunks where aligned); each thread gathers its row of
//    inv[act] through L2 as soon as the mask is known, while its theta
//    products (its rows of Dth, Uth_off and f_theta, one pass) run. Staging
//    the subset table as well measured slower at m = 5 and 8 (PERF.md,
//    K2);
//  * act and side arrive as one byte per row and become team-uniform bit
//    masks by a ballot.
// Every sum keeps polish_plain's index order (each row's dot product k = 0,
// 1, ...; quad and lin term by term on the team's first thread), and the
// library is built with -fmad=false, so kernel and plain version agree bit
// for bit; the two maxima pass a NaN on, as amax and torch.maximum do.

#include <cuda_runtime.h>
#include <stdint.h>

#include "team.cuh"

namespace {

constexpr int kThreads = 128;
constexpr size_t kSmemLimit = 232448 - 1024;  // sm_90's block limit less static room

__host__ __device__ constexpr size_t up2(size_t x) { return (x + 1) & ~size_t(1); }

// Offsets (in doubles) of the statics packed by ops/polish.py, in order:
// Dth (m, nth), du (m), dl (m), G (m, m), HinvET (n, m), Uth_off (n, nth),
// u_off (n), H (n, n), f (n), f_theta (n, nth).
struct Layout {
  int Dth, du, dl, G, HET, Uth, uoff, H, f, fth, total;
};

__host__ __device__ inline Layout layout(int m, int n, int nth) {
  Layout l;
  l.Dth = 0;
  l.du = l.Dth + m * nth;
  l.dl = l.du + m;
  l.G = l.dl + m;
  l.HET = l.G + m * m;
  l.Uth = l.HET + n * m;
  l.uoff = l.Uth + n * nth;
  l.H = l.uoff + n;
  l.f = l.H + n * n;
  l.fth = l.f + n;
  l.total = l.fth + n * nth;
  return l;
}

// Shared memory of a block, in doubles: [statics][theta rows][U, quad and
// lin terms of each lane].
struct Smem {
  size_t stat, theta, lane, total;
};

__host__ __device__ inline Smem smem_plan(int m, int n, int nth, int lanes, bool stage_stat) {
  Smem s;
  s.stat = stage_stat ? up2(layout(m, n, nth).total) : 0;
  s.theta = up2(size_t(lanes) * nth);
  s.lane = up2(3 * size_t(lanes) * n);
  s.total = s.stat + s.theta + s.lane;
  return s;
}

// sum_j A[j] x[j], j = 0 .. len-1 in order (len >= 1)
__device__ __forceinline__ double dot(const double* A, const double* x, int len) {
  double s = A[0] * x[0];
#pragma unroll 4
  for (int j = 1; j < len; ++j) s = s + A[j] * x[j];
  return s;
}

template <int M, int T>
__global__ void __launch_bounds__(kThreads) polish_kernel(
    const double* __restrict__ subset, const double* __restrict__ statics,
    const double* __restrict__ theta, const uint8_t* __restrict__ act_in,
    const uint8_t* __restrict__ side_in, double* __restrict__ U_o, double* __restrict__ lam_o,
    double* __restrict__ fval_o, double* __restrict__ bad_o, int B, int n, int nth,
    unsigned eq_mask, unsigned immut_mask, int stage_stat) {
  constexpr int L = kThreads / T;  // lanes of a block
  extern __shared__ __align__(16) double smem[];
  const Layout lay = layout(M, n, nth);
  const Smem sp = smem_plan(M, n, nth, L, stage_stat);
  double* st_s = smem;
  double* th_s = st_s + sp.stat;
  double* lane_s = th_s + sp.theta;

  const int b0 = blockIdx.x * L;
  const int nb = min(L, B - b0);
  if (stage_stat) team::stage<8>(st_s, statics, sizeof(double) * lay.total, threadIdx.x, kThreads);
  team::stage<8>(th_s, theta + static_cast<size_t>(b0) * nth, sizeof(double) * nb * nth,
                 threadIdx.x, kThreads);

  const int lane = threadIdx.x / T, t = threadIdx.x % T;
  const int b = b0 + lane;
  const bool live = lane < nb, row = t < M;
  const unsigned tmask = team::mask<T>();
  const size_t o = static_cast<size_t>(b) * M + t;
  const bool a_in = live && row && act_in[o];
  const bool s_in = live && row && side_in[o];
  team::wait_all();
  __syncthreads();
  if (!live) return;  // a whole team leaves; no block barrier follows

  const unsigned act = team::ballot<T>(tmask, a_in);
  const unsigned side = team::ballot<T>(tmask, s_in);
  const double* st = stage_stat ? st_s : statics;
  const double* th = th_s + lane * nth;
  const double big = 3.0e38;

  // this thread's row of the working-set inverse, gathered through L2 while
  // the theta products below run
  double inv[M];
  if (row) {
    const double* src = subset + static_cast<size_t>(act) * M * M + t * M;
#pragma unroll
    for (int k = 0; k < M; ++k) inv[k] = __ldg(src + k);
  }

  // the theta products of row t (d) and of n-row t (U and f's parts), three
  // independent sums in one pass
  double dt = 0.0, ut = 0.0, ft = 0.0;
  {
    const double* Dr = st + lay.Dth + (row ? t : 0) * nth;
    const double* Ur = st + lay.Uth + (t < n ? t : 0) * nth;
    const double* Fr = st + lay.fth + (t < n ? t : 0) * nth;
    dt = Dr[0] * th[0];
    ut = Ur[0] * th[0];
    ft = Fr[0] * th[0];
#pragma unroll 4
    for (int j = 1; j < nth; ++j) {
      const double x = th[j];
      dt = dt + Dr[j] * x;
      ut = ut + Ur[j] * x;
      ft = ft + Fr[j] * x;
    }
  }

  // transformed bounds d = d0 + Dth theta and the working-set right side
  double du = 0.0, dl = 0.0, rhs = 0.0;
  if (row) {
    du = st[lay.du + t] + dt;
    dl = st[lay.dl + t] + dt;
    if ((act >> t) & 1u) rhs = -(((side >> t) & 1u) ? du : dl);
  }
  double r[M];
#pragma unroll
  for (int k = 0; k < M; ++k) r[k] = __shfl_sync(tmask, rhs, k, T);

  // lam = inv[act] @ rhs, row t
  double lam_t = 0.0;
  if (row) {
    double s = inv[0] * r[0];
#pragma unroll
    for (int k = 1; k < M; ++k) s = s + inv[k] * r[k];
    lam_t = s;
  }
  double lam[M];
#pragma unroll
  for (int k = 0; k < M; ++k) lam[k] = __shfl_sync(tmask, lam_t, k, T);

  // primal recovery U = (u_off + Uth theta) - HinvET lam, rows t, t + T, ...
  double* U = lane_s + static_cast<size_t>(lane) * 3 * n;
  double* qt = U + n;
  double* lt = qt + n;
  double* Uo = U_o + static_cast<size_t>(b) * n;
  for (int rr = t; rr < n; rr += T) {
    const double* Hr = st + lay.HET + rr * M;
    double hl = Hr[0] * lam[0];
#pragma unroll
    for (int k = 1; k < M; ++k) hl = hl + Hr[k] * lam[k];
    const double uth = rr == t ? ut : dot(st + lay.Uth + rr * nth, th, nth);
    const double u = (st[lay.uoff + rr] + uth) - hl;
    U[rr] = u;
    Uo[rr] = u;
  }
  __syncwarp(tmask);

  // the objective's terms U_r (H U)_r and (f + fth theta)_r U_r
  for (int rr = t; rr < n; rr += T) {
    const double hu = dot(st + lay.H + rr * n, U, n);
    const double f = st[lay.f + rr] + (rr == t ? ft : dot(st + lay.fth + rr * nth, th, nth));
    qt[rr] = U[rr] * hu;
    lt[rr] = f * U[rr];
  }

  // KKT residual: inactive-row primal violation, removable-row sign
  double v = -big;
  if (row) {
    const double* Gr = st + lay.G + t * M;
    double c = Gr[0] * lam[0];
#pragma unroll
    for (int k = 1; k < M; ++k) c = c + Gr[k] * lam[k];
    const bool a = (act >> t) & 1u;
    double primal = -big, sgn = -big;
    if (!a && !((immut_mask >> t) & 1u)) primal = gi::nan_max(-(du + c), dl + c);
    if (a && !((eq_mask >> t) & 1u)) sgn = ((side >> t) & 1u) ? -lam_t : lam_t;
    v = gi::nan_max(primal, sgn);
    lam_o[o] = lam_t;
  }
  v = team::max<T>(tmask, v);
  __syncwarp(tmask);
  if (t == 0) {
    double quad = qt[0], lin = lt[0];
    for (int rr = 1; rr < n; ++rr) {
      quad = quad + qt[rr];
      lin = lin + lt[rr];
    }
    fval_o[b] = 0.5 * quad + lin;
    bad_o[b] = v;
  }
}

template <int M, int T>
cudaError_t launch(const void* subset, const void* statics, const void* theta, const void* act,
                   const void* side, void* U, void* lam, void* fval, void* bad, int B, int n,
                   int nth, unsigned eq_mask, unsigned immut_mask, cudaStream_t stream) {
  constexpr int L = kThreads / T;
  // the statics in shared memory where they fit beside the lanes' arrays,
  // else read through L1/L2
  const bool stage_stat = smem_plan(M, n, nth, L, true).total * sizeof(double) <= kSmemLimit;
  const size_t bytes = smem_plan(M, n, nth, L, stage_stat).total * sizeof(double);
  if (bytes > kSmemLimit) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        polish_kernel<M, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (e != cudaSuccess) return e;
  }
  polish_kernel<M, T><<<(B + L - 1) / L, kThreads, bytes, stream>>>(
      static_cast<const double*>(subset), static_cast<const double*>(statics),
      static_cast<const double*>(theta), static_cast<const uint8_t*>(act),
      static_cast<const uint8_t*>(side), static_cast<double*>(U), static_cast<double*>(lam),
      static_cast<double*>(fval), static_cast<double*>(bad), B, n, nth, eq_mask, immut_mask,
      stage_stat);
  return cudaGetLastError();
}

// The team size: the smallest power of two >= max(m, n), from 4 to 16.
int team_size(int m, int n) {
  const int need = m > n ? m : n;
  return need <= 4 ? 4 : (need <= 8 ? 8 : 16);
}

}  // namespace

// subset (2^m, m, m) and statics (packed as layout() says) float64; theta
// (B, nth) float64; act/side (B, m) one byte per entry; outputs U (B, n),
// lam (B, m), fval (B), bad (B) float64, all contiguous. Returns the
// cudaError_t of the launch.
extern "C" int lmpc_polish(int m, const void* subset, const void* statics, const void* theta,
                           const void* act, const void* side, void* U, void* lam, void* fval,
                           void* bad, int B, int n, int nth, unsigned eq_mask,
                           unsigned immut_mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || n < 1 || nth < 1) return cudaErrorInvalidValue;
  const int T = team_size(m, n);
#define LMPC_CASE(MV, TV)                                                                  \
  if (m == MV && T == TV)                                                                  \
    return launch<MV, TV>(subset, statics, theta, act, side, U, lam, fval, bad, B, n, nth, \
                          eq_mask, immut_mask, s);
  LMPC_CASE(1, 4) LMPC_CASE(1, 8) LMPC_CASE(1, 16)
  LMPC_CASE(2, 4) LMPC_CASE(2, 8) LMPC_CASE(2, 16)
  LMPC_CASE(3, 4) LMPC_CASE(3, 8) LMPC_CASE(3, 16)
  LMPC_CASE(4, 4) LMPC_CASE(4, 8) LMPC_CASE(4, 16)
  LMPC_CASE(5, 8) LMPC_CASE(5, 16) LMPC_CASE(6, 8) LMPC_CASE(6, 16)
  LMPC_CASE(7, 8) LMPC_CASE(7, 16) LMPC_CASE(8, 8) LMPC_CASE(8, 16)
  LMPC_CASE(9, 16) LMPC_CASE(10, 16)
#undef LMPC_CASE
  return cudaErrorInvalidValue;
}
