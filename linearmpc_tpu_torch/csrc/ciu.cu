// K4: the compact working-set GI bulk phase, one warp per lane up to
// s = 64, whole early-exit loop in the kernel.
//
// Replaces linearmpc_tpu/ops/pallas_ciu.py::_ciu_iteration_kernel (looped
// there by phase1_ciu_pallas_while). The iteration is K3's (gi::lane in
// gi_common.cuh) with the carried inverse restricted to s working-set
// slots: Rw (s x s) over the slots' rows, identity rows on free slots, and
// the slot assignment as an int map slot_row[s] (-1 free) with its inverse
// slot_of[m] and a free-slot bit mask, in place of the Pallas kernel's
// one-hot (s*m) SEL matrix and its movement-matrix gathers. An add takes
// the first free slot, a removal frees the slot that held the row, the
// dual blocker is the first ROW with the smallest step (all as the Pallas
// kernel), and a full add with every slot occupied sets the lane's
// overflow flag and ends it. A lane whose entry working set has more rows
// than slots starts done with the flag set (compact_iu.py:106).
//
// What bounds it: the latency of one lane's iteration, as K3, over
// O(s^2 + m * |W|) work (the slack G @ lam_base walks only the nonzero
// multipliers, so it reads the columns of the working set and the pending
// candidate). A warp runs a lane where s <= 64 (the f32 bulk phase at
// s = 16, the second chance at s2 = 32, the f64 guard at 32); G and G_solve
// (128 KB in f32 at m = 128) sit in shared memory once per block where they
// fit, 14 lanes beside them. The f64 guard ladder (s = 96-192) runs the
// same loop with a 128-thread team per lane; Rw above the shared-memory
// budget (s = 192 in f64) is updated in place in the output buffer.

#include "gi_common.cuh"

namespace {

template <typename T, int NT>
__global__ void __launch_bounds__(gi::block_threads(NT), 1) ciu_kernel(gi::Args<T> a) {
  gi::run_lanes<T, true, NT>(a);
}

template <typename T>
cudaError_t run(int m, int s, int B, const void* GT, const void* GsT, const void* du,
                const void* dl, const void* eq, int eq_stride, const void* immut,
                const void* lam0, const void* act0, const void* side0, const void* slots0,
                const void* Rw0, long long Rw0_stride, void* lam, void* act, void* side,
                void* iters, void* done, void* infeas, void* ovf, void* slots, void* Rw,
                void* work, int max_iter, double ptol, double stol, double gtol, double big,
                int retry, cudaStream_t stream) {
  gi::Args<T> a{};
  a.m = m;
  a.s = s;
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
  a.slots0 = static_cast<const int32_t*>(slots0);
  a.inv0 = static_cast<const T*>(Rw0);
  a.inv0_stride = Rw0_stride;
  a.lam = static_cast<T*>(lam);
  a.act = static_cast<uint8_t*>(act);
  a.side = static_cast<uint8_t*>(side);
  a.iters = static_cast<int32_t*>(iters);
  a.done = static_cast<uint8_t*>(done);
  a.infeas = static_cast<uint8_t*>(infeas);
  a.ovf = static_cast<uint8_t*>(ovf);
  a.slots = static_cast<int32_t*>(slots);
  a.inv = static_cast<T*>(Rw);
  a.work = static_cast<int*>(work);
  a.max_iter = max_iter;
  a.ptol = static_cast<T>(ptol);
  a.stol = static_cast<T>(stol);
  a.gtol = static_cast<T>(gtol);
  a.big = static_cast<T>(big);
  a.retry = retry;
  return gi::launch<T, true>(ciu_kernel<T, 32>, ciu_kernel<T, gi::kWide>, a, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = float64. Arrays batch-major: du/dl/lam0 (B, m),
// slots0/slots (B, s) int32 (-1 = free slot), Rw (B, s, s) row-major, Rw0
// the same with batch stride Rw0_stride elements (0: one (s, s) entry
// inverse for every lane), bool arrays one byte per entry; GT and GsT are
// G and G_solve transposed (m, m); eq is (m,) with eq_stride 0 or (B, m)
// with eq_stride m; work is one int32 of scratch. Returns the cudaError_t
// of the launch.
extern "C" int lmpc_ciu(int dtype, int m, int s, int B, const void* GT, const void* GsT,
                        const void* du, const void* dl, const void* eq, int eq_stride,
                        const void* immut, const void* lam0, const void* act0,
                        const void* side0, const void* slots0, const void* Rw0,
                        long long Rw0_stride, void* lam, void* act, void* side, void* iters,
                        void* done, void* infeas, void* ovf, void* slots, void* Rw, void* work,
                        int max_iter, double ptol, double stol, double gtol, double big,
                        int retry, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m < 1 || s < 1 || s > m || B < 1) return cudaErrorInvalidValue;
  if (dtype == 0)
    return run<float>(m, s, B, GT, GsT, du, dl, eq, eq_stride, immut, lam0, act0, side0,
                      slots0, Rw0, Rw0_stride, lam, act, side, iters, done, infeas, ovf, slots,
                      Rw, work, max_iter, ptol, stol, gtol, big, retry, st);
  if (dtype == 1)
    return run<double>(m, s, B, GT, GsT, du, dl, eq, eq_stride, immut, lam0, act0, side0,
                       slots0, Rw0, Rw0_stride, lam, act, side, iters, done, infeas, ovf,
                       slots, Rw, work, max_iter, ptol, stol, gtol, big, retry, st);
  return cudaErrorInvalidValue;
}
