// The float64 finish of the small-m warm rollout step: the gather of the
// lanes it takes and the merge of its results, one launch each.
//
// Replaces no Pallas kernel: the JAX package's rollout step has no finish
// (linearmpc_tpu/ops/engine.py:1218-1241 leaves such lanes at -1).
// SolverEngine.fused_rollout_solve takes the first K lanes, in lane order,
// that fail the step's status rule, without a host read: the gather places
// failing lane b in slot b - cum_ok[b], where cum_ok is the inclusive prefix
// count of passing lanes (torch.cumsum); it continues the K slots on K1's
// float64 instantiation (continue_from_state) and re-solves them with K2,
// and the merge writes the results back into only the slots' lanes that
// failed. Written as torch ops (a top-k, gathers,
// masked scatters) that is some thirty launches a control step.
//
//   gather, lane b failing with slot j = b - cum_ok[b] < K:
//     idx[j] = b;  take[j] = 1;  th_k[j] = th[b];  lam_k[j] = (double) lam[b];
//     act_k[j] = act[b];  side_k[j] = side[b];  iters_k[j] = iters[b]
//   and each slot j beyond the failing lanes the same from lane 0, take 0;
//   merge, slot j with take[j], lane b = idx[j]:
//     U[b] = U_f[j];  lam[b] = lam_f[j];  act[b] = act_f[j];
//     side[b] = side_f[j];  iters[b] = it_f[j];
//     status[b] = done_f[j] && bad_f[j] <= tol ? 1 : -1
//
// The gather runs a thread a lane over the batch (it reads ok and cum_ok,
// 5 bytes a lane, and copies a few hundred bytes a slot), the merge a thread
// a slot. The taken lanes are distinct, so no two slots write one lane.
// Values are copied, and the comparison is the plain version's (a NaN
// residual fails it), so kernel and plain version (ops/roll_finish.py) agree
// bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

inline int blocks(int n) { return (n + kThreads - 1) / kThreads; }

struct Gather {
  const double* th;
  const float* lam;
  const uint8_t* act;
  const uint8_t* side;
  const int32_t* iters;
  int64_t* idx;
  uint8_t* take;
  double* th_k;
  double* lam_k;
  uint8_t* act_k;
  uint8_t* side_k;
  int32_t* iters_k;
  int m, nth;
};

__device__ void put(const Gather& g, int slot, int64_t lane, bool taken) {
  g.idx[slot] = lane;
  g.take[slot] = taken;
  for (int i = 0; i < g.nth; ++i) g.th_k[size_t(slot) * g.nth + i] = g.th[lane * g.nth + i];
  for (int i = 0; i < g.m; ++i) {
    g.lam_k[size_t(slot) * g.m + i] = double(g.lam[lane * g.m + i]);
    g.act_k[size_t(slot) * g.m + i] = g.act[lane * g.m + i];
    g.side_k[size_t(slot) * g.m + i] = g.side[lane * g.m + i];
  }
  g.iters_k[slot] = g.iters[lane];
}

// Thread b places lane b in slot b - cum_ok[b] where it fails (cum_ok the
// inclusive prefix count of passing lanes), and, for b < K beyond the
// failing lanes, lane 0 in slot b, not to be merged.
__global__ void gather_kernel(const uint8_t* __restrict__ ok, const int32_t* __restrict__ cum_ok,
                              Gather g, int B, int K) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  if (!ok[b] && b - cum_ok[b] < K) put(g, b - cum_ok[b], b, true);
  if (b < K && b >= B - cum_ok[B - 1]) put(g, b, 0, false);
}

__global__ void merge_kernel(const int64_t* __restrict__ idx, const uint8_t* __restrict__ take,
                             const double* __restrict__ U_f, const double* __restrict__ lam_f,
                             const uint8_t* __restrict__ act_f, const uint8_t* __restrict__ side_f,
                             const int32_t* __restrict__ it_f, const uint8_t* __restrict__ done_f,
                             const double* __restrict__ bad_f,
                             double* __restrict__ U, double* __restrict__ lam,
                             uint8_t* __restrict__ act, uint8_t* __restrict__ side,
                             int32_t* __restrict__ iters, int32_t* __restrict__ status, int K,
                             int m, int n, double tol) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= K || !take[j]) return;
  const int64_t b = idx[j];
  for (int i = 0; i < n; ++i) U[b * n + i] = U_f[size_t(j) * n + i];
  for (int i = 0; i < m; ++i) {
    lam[b * m + i] = lam_f[size_t(j) * m + i];
    act[b * m + i] = act_f[size_t(j) * m + i];
    side[b * m + i] = side_f[size_t(j) * m + i];
  }
  iters[b] = it_f[j];
  status[b] = (done_f[j] && bad_f[j] <= tol) ? 1 : -1;
}

}  // namespace

// ok (B) one byte a lane, cum_ok (B) int32 its inclusive prefix count; th
// (B, nth) float64, lam (B, m) float32, act/side (B, m) one byte per entry,
// iters (B) int32; outputs idx (K) int64, take (K) bytes, th_k (K, nth) and
// lam_k (K, m) float64, act_k/side_k (K, m) bytes, iters_k (K) int32; all
// contiguous, 1 <= K <= B. Returns the launch's cudaError_t.
extern "C" int lmpc_roll_gather(int B, int K, int m, int nth, const void* ok, const void* cum_ok,
                                const void* th, const void* lam, const void* act,
                                const void* side, const void* iters, void* idx, void* take,
                                void* th_k, void* lam_k, void* act_k, void* side_k,
                                void* iters_k, void* stream) {
  if (K < 1 || K > B || m < 1 || nth < 0) return cudaErrorInvalidValue;
  Gather g{static_cast<const double*>(th),   static_cast<const float*>(lam),
           static_cast<const uint8_t*>(act), static_cast<const uint8_t*>(side),
           static_cast<const int32_t*>(iters), static_cast<int64_t*>(idx),
           static_cast<uint8_t*>(take),      static_cast<double*>(th_k),
           static_cast<double*>(lam_k),      static_cast<uint8_t*>(act_k),
           static_cast<uint8_t*>(side_k),    static_cast<int32_t*>(iters_k),
           m,                                nth};
  gather_kernel<<<blocks(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(ok), static_cast<const int32_t*>(cum_ok), g, B, K);
  return cudaGetLastError();
}

// idx and take as the gather left them; the finish's U_f (K, n) and lam_f
// (K, m) float64, act_f/side_f (K, m) and done_f (K) bytes, it_f (K) int32
// (its iterations counted from the step's), bad_f (K) float64; the
// step's U (B, n), lam (B, m) float64, act/side (B, m) bytes, iters and
// status (B) int32, written in place on the lanes of the slots taken; all
// contiguous.
extern "C" int lmpc_roll_merge(int K, int m, int n, const void* idx, const void* take,
                               const void* U_f, const void* lam_f, const void* act_f,
                               const void* side_f, const void* it_f, const void* done_f,
                               const void* bad_f, void* U, void* lam, void* act, void* side,
                               void* iters, void* status, double tol, void* stream) {
  if (K < 1 || m < 1 || n < 1) return cudaErrorInvalidValue;
  merge_kernel<<<blocks(K), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(idx), static_cast<const uint8_t*>(take),
      static_cast<const double*>(U_f), static_cast<const double*>(lam_f),
      static_cast<const uint8_t*>(act_f), static_cast<const uint8_t*>(side_f),
      static_cast<const int32_t*>(it_f), static_cast<const uint8_t*>(done_f),
      static_cast<const double*>(bad_f),
      static_cast<double*>(U), static_cast<double*>(lam), static_cast<uint8_t*>(act),
      static_cast<uint8_t*>(side), static_cast<int32_t*>(iters), static_cast<int32_t*>(status),
      K, m, n, tol);
  return cudaGetLastError();
}
