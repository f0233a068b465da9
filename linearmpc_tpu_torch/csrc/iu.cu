// K3: the Goldfarb-Idnani inverse-update bulk phase, one warp per lane,
// whole early-exit loop in the kernel.
//
// Replaces linearmpc_tpu/ops/pallas_iu.py::_iu_iteration_kernel (looped
// there by phase1_iu_pallas / phase1_iu_pallas_while, one gridless call
// per iteration, and by make_iu_stepper, K iterations a call over state the
// caller keeps). Each lane carries the masked working-set inverse R (m x m)
// and runs the iteration of dual_active_set.py::_active_set_loop_iu
// (gi::lane in gi_common.cuh with the inverse over all m rows).
//
// What bounds it: the latency of one lane's iteration, a chain of short
// sums over the working set (a few thousand multiply-adds per iteration
// against ~9.2 KB of R per lane in f32 at m = 48). The design cuts that
// chain: a warp runs a lane, so its barriers are __syncwarp and its
// arg-reductions shuffles; every product walks the ascending list of the
// nonzero entries only; G and G_solve sit in shared memory once per block
// (18.4 KB in f32 at m = 48); R and every per-row vector of the lane live
// in shared memory, 16 lanes to a block, and a lane that finishes takes the
// next one. No TPU workaround is carried over: no one-hot movement
// matrices, no ones-column expansions, no triangular-matmul first-hit
// masks.
//
// Two entries. lmpc_iu starts every lane with no pending row and runs it to
// convergence: the float instantiation is the IU tier's bulk phase and the
// warm rollout step (big = 3e38, gamma_tol = 3.5e-4), the double one the
// f64 straggler re-solve (big = 1e30, gamma_tol = sqrt(eps)). lmpc_iu_step
// resumes each lane from its whole state (pending row and side, done,
// infeas) for at most K iterations and returns that state: the stepper of
// the hybrid branch-and-bound's rounds, whose GI state lives across them
// (on the CPU, and where a caller inspects the rounds one at a time; on the
// card the search entry, inc_search.cu, runs the whole search).
// Sentinels and tolerances come from the caller.

#include "gi_common.cuh"

namespace {

template <typename T, int NT>
__global__ void __launch_bounds__(gi::block_threads(NT), 1) iu_kernel(gi::Args<T> a) {
  gi::run_lanes<T, false, NT>(a);
}

template <typename T>
cudaError_t run(gi::Args<T> a, int m, int B, const void* GT, const void* GsT, const void* du,
                const void* dl, const void* eq, int eq_stride, const void* immut,
                const void* lam0, const void* act0, const void* side0, const void* R0,
                long long R0_stride, void* lam, void* act, void* side, void* iters, void* done,
                void* infeas, void* R, void* work, int max_iter, double ptol, double stol,
                double gtol, double big, int retry, cudaStream_t stream) {
  a.m = m;
  a.s = m;
  a.B = B;
  a.GT = static_cast<const T*>(GT);
  a.GsT = static_cast<const T*>(GsT);
  a.du_t = static_cast<const T*>(du);
  a.dl_t = static_cast<const T*>(dl);
  a.eq = static_cast<const uint8_t*>(eq);
  a.eq_stride = eq_stride;
  a.immut = static_cast<const uint8_t*>(immut);
  a.lam0 = static_cast<const T*>(lam0);
  a.act0 = static_cast<const uint8_t*>(act0);
  a.side0 = static_cast<const uint8_t*>(side0);
  a.inv0 = static_cast<const T*>(R0);
  a.inv0_stride = R0_stride;
  a.lam = static_cast<T*>(lam);
  a.act = static_cast<uint8_t*>(act);
  a.side = static_cast<uint8_t*>(side);
  a.iters = static_cast<int32_t*>(iters);
  a.done = static_cast<uint8_t*>(done);
  a.infeas = static_cast<uint8_t*>(infeas);
  a.inv = static_cast<T*>(R);
  a.work = static_cast<int*>(work);
  a.max_iter = max_iter;
  a.ptol = static_cast<T>(ptol);
  a.stol = static_cast<T>(stol);
  a.gtol = static_cast<T>(gtol);
  a.big = static_cast<T>(big);
  a.retry = retry;
  return gi::launch<T, false>(iu_kernel<T, 32>, iu_kernel<T, gi::kWide>, a, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = float64. Arrays batch-major: du/dl/lam0 (B, m),
// R (B, m, m) row-major, R0 the same with batch stride R0_stride elements
// (0: one (m, m) entry inverse for every lane), bool arrays one byte per
// entry; GT and GsT are G and G_solve transposed (m, m); eq is (m,) with
// eq_stride 0 or (B, m) with eq_stride m; work is one int32 of scratch.
// Returns the cudaError_t of the launch.
extern "C" int lmpc_iu(int dtype, int m, int B, const void* GT, const void* GsT,
                       const void* du, const void* dl, const void* eq, int eq_stride,
                       const void* immut, const void* lam0, const void* act0,
                       const void* side0, const void* R0, long long R0_stride, void* lam,
                       void* act, void* side, void* iters, void* done, void* infeas, void* R,
                       void* work, int max_iter, double ptol, double stol, double gtol,
                       double big, int retry, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || B < 1) return cudaErrorInvalidValue;
  if (dtype == 0)
    return run<float>(gi::Args<float>{}, m, B, GT, GsT, du, dl, eq, eq_stride, immut, lam0,
                      act0, side0, R0, R0_stride, lam, act, side, iters, done, infeas, R, work,
                      max_iter, ptol, stol, gtol, big, retry, s);
  if (dtype == 1)
    return run<double>(gi::Args<double>{}, m, B, GT, GsT, du, dl, eq, eq_stride, immut, lam0,
                       act0, side0, R0, R0_stride, lam, act, side, iters, done, infeas, R,
                       work, max_iter, ptol, stol, gtol, big, retry, s);
  return cudaErrorInvalidValue;
}

// The resumable entry: as lmpc_iu, plus each lane's pending row pend0
// (int32, -1 for none), its side pside0, done0 and infeas0 (one byte each)
// in, pend and pside out; at most K iterations a lane, counted in iters.
extern "C" int lmpc_iu_step(int dtype, int m, int B, const void* GT, const void* GsT,
                            const void* du, const void* dl, const void* eq, int eq_stride,
                            const void* immut, const void* lam0, const void* act0,
                            const void* side0, const void* pend0, const void* pside0,
                            const void* done0, const void* infeas0, const void* R0,
                            long long R0_stride, void* lam, void* act, void* side, void* pend,
                            void* pside, void* iters, void* done, void* infeas, void* R,
                            void* work, int K, double ptol, double stol, double gtol,
                            double big, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || B < 1 || pend0 == nullptr) return cudaErrorInvalidValue;
  if (dtype == 0) {
    gi::Args<float> a{};
    a.pend0 = static_cast<const int32_t*>(pend0);
    a.pside0 = static_cast<const uint8_t*>(pside0);
    a.done0 = static_cast<const uint8_t*>(done0);
    a.infeas0 = static_cast<const uint8_t*>(infeas0);
    a.pend = static_cast<int32_t*>(pend);
    a.pside = static_cast<uint8_t*>(pside);
    return run<float>(a, m, B, GT, GsT, du, dl, eq, eq_stride, immut, lam0, act0, side0, R0,
                      R0_stride, lam, act, side, iters, done, infeas, R, work, K, ptol, stol,
                      gtol, big, 0, s);
  }
  if (dtype == 1) {
    gi::Args<double> a{};
    a.pend0 = static_cast<const int32_t*>(pend0);
    a.pside0 = static_cast<const uint8_t*>(pside0);
    a.done0 = static_cast<const uint8_t*>(done0);
    a.infeas0 = static_cast<const uint8_t*>(infeas0);
    a.pend = static_cast<int32_t*>(pend);
    a.pside = static_cast<uint8_t*>(pside);
    return run<double>(a, m, B, GT, GsT, du, dl, eq, eq_stride, immut, lam0, act0, side0, R0,
                       R0_stride, lam, act, side, iters, done, infeas, R, work, K, ptol, stol,
                       gtol, big, 0, s);
  }
  return cudaErrorInvalidValue;
}

// The launch plan the last K3 launch on this host thread chose: team
// threads, lanes a block, blocks, matrices staged, inverse in shared
// memory, shared-memory bytes a block (six ints into out).
extern "C" int lmpc_iu_plan(int* out) {
  const gi::Plan p = gi::last_plan;
  out[0] = p.team;
  out[1] = p.lanes;
  out[2] = p.blocks;
  out[3] = p.g_staged;
  out[4] = p.inv_in_smem;
  out[5] = p.smem;
  return 0;
}
