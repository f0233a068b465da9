// The warm IU rollout step's epilogue in one launch: everything
// SolverEngine.fused_rollout_solve_iu does after K3, for each lane.
//
// Replaces no Pallas kernel. The JAX package leaves this stretch of its
// fused rollout (linearmpc_tpu/ops/engine.py:355-410) to XLA, which fuses
// it into the rollout's scan; run as plain torch on the card it is about a
// hundred small launches a control step (SolverEngine.
// _rollout_epilogue_plain, its plain version). Per lane, from K3's float32
// carried inverse R, working set (act, side), done and infeas flags and the
// step's theta:
//
//  * one Newton-Schulz pass in float32, R <- R (2 I - M R) with
//    M = Gs o (act act^T) + diag(1 - act) and Gs = G_solve + 4 eps32 I;
//  * the bounds du + Dth theta, dl + Dth theta in float64;
//  * float64 Richardson refinement of the working-set multipliers through
//    the new R (each residual rounded to float32, multiplied by R in float32,
//    added back in float64), `refine` passes;
//  * U = u_off + Uth_off theta - HinvET lam in float64;
//  * the relative working-set residual against res_tol, and the status:
//    -3 where K3 flagged the lane infeasible, 1 where it is done and the
//    residual is within res_tol, else -1.
//
// What bounds it: R in and out, 2 m^2 float32 a lane (52 MB a 4096-lane
// step at m = 40, 15.6 us at 3.35 TB/s), and the two m^3 float32 products of
// the Newton-Schulz pass (1.05 GFLOP, 15.6 us at 67 TFLOP/s); the float64
// passes are ~10^4 multiply-adds a lane. The design: a warp runs a lane, a
// block holds up to kMaxWarps lanes and stays resident, one block an SM.
// Each thread owns an RI x 2RI tile of every m x m matrix (RI = ceil(m / 8);
// 8 row groups by 4 column groups). A product walks k four at a time: RI
// float4 loads of the left operand and 4 RI float2 loads of the right one
// for 8 RI^2 multiply-adds, summed with __fmaf_rn; the lane's R and the
// second operand (M, then 2 I - M R) sit in shared memory, rows padded by
// four words so that neither operand's loads conflict. The new R stays in
// registers as the thread's tile, and so does the thread's tile of the
// float64 G_solve, loaded once a warp: a Richardson pass multiplies by both
// there and sums the four column groups with two shuffles, reading only
// vectors from shared memory. Gs is staged once a block, and so are the
// statics read once a lane (HinvET, Uth_off, Dth, du, dl, u_off); the launch
// fails where they leave no room for a lane. R is read
// once, in 16-byte cp.async pieces that fetch the warp's next lane behind its
// float64 work, and written once, in 16-byte stores.
//
// Sums run in another order than the plain version's cuBLAS products, so
// the two agree to rounding, not bit for bit. Non-finite values propagate
// as in the plain version: every product takes every term, and the
// residual's maximum passes NaN on.

#include <algorithm>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;  // lanes of a block
constexpr int kMaxRI = 7;     // m <= 56
// a block's dynamic shared memory: sm_90's 232448 bytes less a margin
constexpr size_t kBlockSmem = 232448 - 1024;

struct Args {
  int m, n, nth, B, refine;
  int rest_bytes;         // the statics read once a lane, staged (set by launch)
  int lane_bytes;         // a lane's shared memory (set by launch)
  double res_tol;
  const float* Gs;        // (m, m) G_solve + 4 eps32 I, float32
  const double* G;        // (m, m) G_solve
  const double* Dth;      // (m, nth)
  const double* du;       // (m,)
  const double* dl;       // (m,)
  const double* u_off;    // (n,)
  const double* Uth;      // (n, nth)
  const double* HinvET;   // (n, m)
  const float* theta;     // (B, nth)
  const float* R;         // (B, m, m)
  const uint8_t* act;     // (B, m)
  const uint8_t* side;    // (B, m)
  const uint8_t* done;    // (B,)
  const uint8_t* infeas;  // (B,)
  float* U;               // (B, n)
  float* lam;             // (B, m)
  float* R_out;           // (B, m, m)
  int32_t* status;        // (B,)
};

constexpr size_t up16(size_t x) { return (x + 15) & ~size_t(15); }

// padded order MP = 8 RI and row stride S = MP + 4 (16-byte rows) of the
// matrices in shared memory
template <int RI>
struct Shape {
  static constexpr int MP = 8 * RI;
  static constexpr int S = MP + 4;
  static constexpr int CJ = 2 * RI;
  static constexpr size_t gs_bytes = up16(size_t(MP) * S * sizeof(float));
  // a lane: lam * act and lam (double, MP each); R and the second operand
  // (MP x S floats each), the float32 residual (MP); then two theta rows
  static constexpr size_t lane_fixed =
      up16(2 * MP * sizeof(double) + (2 * MP * S + MP) * sizeof(float));
  static size_t lane(int nth) { return lane_fixed + up16(2 * sizeof(float) * nth); }
};

// the statics read once a lane, staged: HinvET (rows of stride m + 1, so
// that a column's rows fall in distinct banks), Uth_off, Dth, du, dl, u_off
size_t rest_doubles(int m, int n, int nth) {
  return size_t(n) * (m + 1) + size_t(n) * nth + size_t(m) * nth + 2 * size_t(m) + n;
}

__device__ __forceinline__ double nan_max(double a, double b) {
  return (b > a || isnan(b)) ? b : a;
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// Whether rows of m floats at p move in 16-byte pieces.
__device__ __forceinline__ bool wide_rows(int m, const void* p) {
  return m % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Start copying lane b's R (into Rs, rows of stride S) and theta row (into
// th) to shared memory; the caller waits with cp.async.wait_all.
template <int RI>
__device__ __forceinline__ void prefetch(const Args& a, int b, float* Rs, float* th, int t) {
  constexpr int MP = Shape<RI>::MP, S = Shape<RI>::S, Q = MP / 4;
  const int m = a.m;
  const float* Rb = a.R + static_cast<size_t>(b) * m * m;
  if (wide_rows(m, a.R)) {
    // the padded geometry: 16-byte pieces of MP rows, those inside m x m
    for (int p = t; p < MP * Q; p += 32) {
      const int i = p / Q, k = 4 * (p % Q);
      if (i < m && k < m) cp_async(Rs + i * S + k, Rb + i * m + k, 16);
    }
  } else {
    for (int p = t; p < m * m; p += 32) cp_async(Rs + (p / m) * S + p % m, Rb + p, 4);
  }
  const float* src = a.theta + static_cast<size_t>(b) * a.nth;
  for (int q = t; q < a.nth; q += 32) cp_async(th + q, src + q, 4);
  asm volatile("cp.async.commit_group;\n" ::);
}

// acc = A B over the padded order: the thread's rows row0.., columns
// col0.. of the MP x MP product of two row-major shared matrices (stride S)
template <int RI>
__device__ __forceinline__ void tile_mm(const float* A, const float* Bm, int row0, int col0,
                                        float (&acc)[RI][2 * RI]) {
  constexpr int MP = Shape<RI>::MP, S = Shape<RI>::S;
#pragma unroll
  for (int r = 0; r < RI; ++r)
#pragma unroll
    for (int c = 0; c < 2 * RI; ++c) acc[r][c] = 0.0f;
  const float* a0 = A + row0 * S;
  const float* b0 = Bm + col0;
#pragma unroll 2
  for (int k = 0; k < MP; k += 4) {
    float4 av[RI];
#pragma unroll
    for (int r = 0; r < RI; ++r) av[r] = *reinterpret_cast<const float4*>(a0 + r * S + k);
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      float2 bv[RI];
#pragma unroll
      for (int p = 0; p < RI; ++p)
        bv[p] = *reinterpret_cast<const float2*>(b0 + (k + h) * S + 2 * p);
#pragma unroll
      for (int r = 0; r < RI; ++r) {
        const float x = h == 0 ? av[r].x : h == 1 ? av[r].y : h == 2 ? av[r].z : av[r].w;
#pragma unroll
        for (int p = 0; p < RI; ++p) {
          acc[r][2 * p] = __fmaf_rn(x, bv[p].x, acc[r][2 * p]);
          acc[r][2 * p + 1] = __fmaf_rn(x, bv[p].y, acc[r][2 * p + 1]);
        }
      }
    }
  }
}

// The thread's rows of R v (R the register tile, v float32 in shared
// memory), summed over the four column groups, in float64.
template <int RI>
__device__ __forceinline__ void apply_R(const float (&Rt)[RI][2 * RI], const float* v, int col0,
                                        double (&y)[RI]) {
  float vc[2 * RI];
#pragma unroll
  for (int p = 0; p < RI; ++p) {
    const float2 x = *reinterpret_cast<const float2*>(v + col0 + 2 * p);
    vc[2 * p] = x.x;
    vc[2 * p + 1] = x.y;
  }
  float s[RI];
#pragma unroll
  for (int r = 0; r < RI; ++r) {
    s[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < 2 * RI; ++c) s[r] = __fmaf_rn(Rt[r][c], vc[c], s[r]);
  }
#pragma unroll
  for (int r = 0; r < RI; ++r) s[r] += __shfl_xor_sync(kFull, s[r], 8);
#pragma unroll
  for (int r = 0; r < RI; ++r) {
    s[r] += __shfl_xor_sync(kFull, s[r], 16);
    y[r] = static_cast<double>(s[r]);
  }
}

// The thread's rows of the masked working-set system applied to lam:
// a_i (G_solve (lam o a))_i + (1 - a_i) lam_i, with G the register tile
// and la = lam o a in shared memory.
template <int RI>
__device__ __forceinline__ void mask_apply(const double (&Gt)[RI][2 * RI], const double* la,
                                           int col0, const double (&lm)[RI],
                                           const double (&ar)[RI], double (&w)[RI]) {
  double lc[2 * RI];
#pragma unroll
  for (int p = 0; p < RI; ++p) {
    const double2 x = *reinterpret_cast<const double2*>(la + col0 + 2 * p);
    lc[2 * p] = x.x;
    lc[2 * p + 1] = x.y;
  }
  double s[RI];
#pragma unroll
  for (int r = 0; r < RI; ++r) {
    s[r] = 0.0;
#pragma unroll
    for (int c = 0; c < 2 * RI; ++c) s[r] = __fma_rn(Gt[r][c], lc[c], s[r]);
  }
#pragma unroll
  for (int r = 0; r < RI; ++r) s[r] += __shfl_xor_sync(kFull, s[r], 8);
#pragma unroll
  for (int r = 0; r < RI; ++r) {
    s[r] += __shfl_xor_sync(kFull, s[r], 16);
    w[r] = ar[r] * s[r] + (1.0 - ar[r]) * lm[r];
  }
}

template <int RI>
__global__ void __launch_bounds__(kMaxWarps * 32, 1) epilogue_kernel(Args a, int warps) {
  using Sh = Shape<RI>;
  constexpr int MP = Sh::MP, S = Sh::S, CJ = Sh::CJ, HALF = MP / 2, Q = MP / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int m = a.m, n = a.n, nth = a.nth;
  // block statics: the once-a-lane statics, then Gs
  double* HinvET = reinterpret_cast<double*>(smem);  // rows of stride m + 1
  double* Uth = HinvET + n * (m + 1);
  double* Dth = Uth + n * nth;
  double* du = Dth + m * nth;
  double* dl = du + m;
  double* u_off = dl + m;
  float* Gs = reinterpret_cast<float*>(smem + a.rest_bytes);

  const int w = threadIdx.x >> 5, t = threadIdx.x & 31;
  unsigned char* base = smem + a.rest_bytes + Sh::gs_bytes + w * a.lane_bytes;
  double* la = reinterpret_cast<double*>(base);
  double* lamv = la + MP;
  float* Rs = reinterpret_cast<float*>(lamv + MP);
  float* Xs = Rs + MP * S;
  float* v32 = Xs + MP * S;
  float* th_buf = reinterpret_cast<float*>(base + Sh::lane_fixed);  // two theta rows, by parity

  // R's pad rows and columns are zero: the copies write inside m x m (and
  // a lane's non-finite R may leave its pads otherwise)
  auto zero_pads = [&]() {
    if (MP > m)
      for (int e = t; e < MP * S; e += 32)
        if (e / S >= m || e % S >= m) Rs[e] = 0.0f;
  };
  // the first lane's R and theta start coming while the block stages the statics
  const int stride = gridDim.x * warps;
  int b = blockIdx.x * warps + w;
  if (b < a.B) {
    zero_pads();
    prefetch<RI>(a, b, Rs, th_buf, t);
  }
  for (int e = threadIdx.x; e < MP * S; e += blockDim.x) {
    const int i = e / S, k = e % S;
    Gs[e] = i < m && k < m ? a.Gs[i * m + k] : 0.0f;
  }
  for (int e = threadIdx.x; e < n * (m + 1); e += blockDim.x) {
    const int j = e / (m + 1), i = e % (m + 1);
    HinvET[e] = i < m ? a.HinvET[j * m + i] : 0.0;
  }
  const double* src[5] = {a.Uth, a.Dth, a.du, a.dl, a.u_off};
  const int len[5] = {n * nth, m * nth, m, m, n};
  double* dst = Uth;
  for (int s = 0; s < 5; dst += len[s], ++s)
    for (int e = threadIdx.x; e < len[s]; e += blockDim.x) dst[e] = src[s][e];

  // the thread's tile: rows row0 .. row0 + RI - 1, columns col0 .. col0 + CJ - 1;
  // G_solve's tile stays in registers for the kernel's life
  const int rg = t & 7, cg = t >> 3;
  const int row0 = RI * rg, col0 = CJ * cg;
  const bool writer = cg == 0;  // column group 0 stores the rows' values
  double Gt[RI][CJ];
#pragma unroll
  for (int r = 0; r < RI; ++r)
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      const int i = row0 + r, j = col0 + c;
      Gt[r][c] = i < m && j < m ? a.G[i * m + j] : 0.0;
    }
  __syncthreads();

  auto bit = [](unsigned long long mask, int i) { return static_cast<int>((mask >> i) & 1ull); };
  // lane b's working set and sides, a byte a row: rows t and t + 32
  auto flags = [&](const uint8_t* f, int lane, int j) {
    return j < m ? f[static_cast<size_t>(lane) * m + j] : uint8_t(0);
  };
  uint8_t act0 = 0, act1 = 0, side0 = 0, side1 = 0;
  if (b < a.B) {
    act0 = flags(a.act, b, t), act1 = flags(a.act, b, t + 32);
    side0 = flags(a.side, b, t), side1 = flags(a.side, b, t + 32);
  }
  const bool wide_out = wide_rows(m, a.R_out);

  for (int parity = 0; b < a.B; b += stride, parity ^= 1) {
    const size_t bm = static_cast<size_t>(b) * m;
    const bool infeas = a.infeas[b], done = a.done[b];
    const unsigned long long amask =
        __ballot_sync(kFull, act0) | static_cast<unsigned long long>(__ballot_sync(kFull, act1))
                                         << 32;
    const unsigned long long smask =
        __ballot_sync(kFull, side0) | static_cast<unsigned long long>(__ballot_sync(kFull, side1))
                                          << 32;
    const float* th = th_buf + parity * nth;

    // M beside R: a_i a_k Gs_ik on the working set, 1 on inactive diagonals
    for (int p = t; p < MP * HALF; p += 32) {
      const int i = p / HALF, k = 2 * (p % HALF);
      const float2 g = *reinterpret_cast<const float2*>(Gs + i * S + k);
      const int ai = bit(amask, i);
      float2 mv;
      mv.x = (ai & bit(amask, k)) ? g.x : (i == k && !ai ? 1.0f : 0.0f);
      mv.y = (ai & bit(amask, k + 1)) ? g.y : (i == k + 1 && !ai ? 1.0f : 0.0f);
      *reinterpret_cast<float2*>(Xs + i * S + k) = mv;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();

    // Newton-Schulz: P = M R, then R (2 I - P)
    float acc[RI][CJ];
    tile_mm<RI>(Xs, Rs, row0, col0, acc);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int p = 0; p < RI; ++p) {
        const int i = row0 + r, j = col0 + 2 * p;
        *reinterpret_cast<float2*>(Xs + i * S + j) =
            make_float2((i == j ? 2.0f : 0.0f) - acc[r][2 * p],
                        (i == j + 1 ? 2.0f : 0.0f) - acc[r][2 * p + 1]);
      }
    __syncwarp();
    tile_mm<RI>(Rs, Xs, row0, col0, acc);
    __syncwarp();
    // the new R out through shared memory, rows whole
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int p = 0; p < RI; ++p)
        *reinterpret_cast<float2*>(Rs + (row0 + r) * S + col0 + 2 * p) =
            make_float2(acc[r][2 * p], acc[r][2 * p + 1]);
    __syncwarp();
    float* Ro = a.R_out + bm * m;
    if (wide_out) {
      for (int p = t; p < MP * Q; p += 32) {
        const int i = p / Q, k = 4 * (p % Q);
        if (i < m && k < m)
          *reinterpret_cast<float4*>(Ro + i * m + k) =
              *reinterpret_cast<const float4*>(Rs + i * S + k);
      }
    } else {
      for (int p = t; p < m * m; p += 32) Ro[p] = Rs[(p / m) * S + p % m];
    }
    __syncwarp();
    // the next lane's R and theta come in behind the float64 work
    const int next = b + stride;
    if (next < a.B) {
      zero_pads();
      prefetch<RI>(a, next, Rs, th_buf + (parity ^ 1) * nth, t);
      act0 = flags(a.act, next, t), act1 = flags(a.act, next, t + 32);
      side0 = flags(a.side, next, t), side1 = flags(a.side, next, t + 32);
    }

    // float64 bounds and the right-hand side of the thread's rows, each row
    // summed over the column groups
    double rh[RI], ar[RI], lm[RI], wv[RI], dt[RI];
#pragma unroll
    for (int r = 0; r < RI; ++r) dt[r] = 0.0;
    for (int q = cg; q < nth; q += 4) {
      const double x = th[q];
#pragma unroll
      for (int r = 0; r < RI; ++r)
        if (row0 + r < m) dt[r] = __fma_rn(x, Dth[(row0 + r) * nth + q], dt[r]);
    }
#pragma unroll
    for (int r = 0; r < RI; ++r) dt[r] += __shfl_xor_sync(kFull, dt[r], 8);
#pragma unroll
    for (int r = 0; r < RI; ++r) {
      const int i = row0 + r;
      dt[r] += __shfl_xor_sync(kFull, dt[r], 16);
      ar[r] = static_cast<double>(bit(amask, i));
      rh[r] = i < m ? -ar[r] * (bit(smask, i) ? du[i] + dt[r] : dl[i] + dt[r]) : 0.0;
      if (writer) v32[i] = static_cast<float>(rh[r]);
    }
    __syncwarp();

    // Richardson through the new R, the thread's rows of the tile
    apply_R<RI>(acc, v32, col0, lm);
    for (int it = 0; it <= a.refine; ++it) {
      if (writer)
#pragma unroll
        for (int r = 0; r < RI; ++r) la[row0 + r] = lm[r] * ar[r];
      __syncwarp();
      mask_apply<RI>(Gt, la, col0, lm, ar, wv);
      if (it == a.refine) break;  // the last system product checks the residual
      if (writer)
#pragma unroll
        for (int r = 0; r < RI; ++r) v32[row0 + r] = static_cast<float>(rh[r] - wv[r]);
      __syncwarp();
      double y[RI];
      apply_R<RI>(acc, v32, col0, y);
#pragma unroll
      for (int r = 0; r < RI; ++r) lm[r] = lm[r] + y[r];
    }

    // the relative working-set residual, NaN passed on (pad rows are 0)
    double res = 0.0, rmax = 0.0;
#pragma unroll
    for (int r = 0; r < RI; ++r) {
      res = nan_max(res, fabs(wv[r] - rh[r]));
      rmax = nan_max(rmax, fabs(rh[r]));
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      res = nan_max(res, __shfl_xor_sync(kFull, res, o));
      rmax = nan_max(rmax, __shfl_xor_sync(kFull, rmax, o));
    }
    const bool ok = res <= a.res_tol * (1.0 + rmax);

    if (writer)
#pragma unroll
      for (int r = 0; r < RI; ++r) {
        const int i = row0 + r;
        if (i < m) {
          lamv[i] = lm[r];
          a.lam[bm + i] = static_cast<float>(lm[r]);
        }
      }
    __syncwarp();
    // U = u_off + Uth_off theta - HinvET lam: rows jb + rg + 8 r, each
    // summed over the column groups
    for (int jb = 0; jb < n; jb += MP) {
      double u1[RI], u2[RI];
#pragma unroll
      for (int r = 0; r < RI; ++r) u1[r] = u2[r] = 0.0;
      for (int q = cg; q < nth; q += 4) {
        const double x = th[q];
#pragma unroll
        for (int r = 0; r < RI; ++r) {
          const int j = jb + rg + 8 * r;
          if (j < n) u1[r] = __fma_rn(x, Uth[j * nth + q], u1[r]);
        }
      }
      for (int i = cg; i < m; i += 4) {
        const double x = lamv[i];
#pragma unroll
        for (int r = 0; r < RI; ++r) {
          const int j = jb + rg + 8 * r;
          if (j < n) u2[r] = __fma_rn(x, HinvET[j * (m + 1) + i], u2[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < RI; ++r) {
        u1[r] += __shfl_xor_sync(kFull, u1[r], 8);
        u2[r] += __shfl_xor_sync(kFull, u2[r], 8);
      }
#pragma unroll
      for (int r = 0; r < RI; ++r) {
        const int j = jb + rg + 8 * r;
        u1[r] += __shfl_xor_sync(kFull, u1[r], 16);
        u2[r] += __shfl_xor_sync(kFull, u2[r], 16);
        if (writer && j < n)
          a.U[static_cast<size_t>(b) * n + j] = static_cast<float>((u_off[j] + u1[r]) - u2[r]);
      }
    }
    if (t == 0) a.status[b] = infeas ? -3 : (done && ok ? 1 : -1);
    __syncwarp();
  }
}

template <int RI>
cudaError_t launch(Args a, cudaStream_t stream) {
  using Sh = Shape<RI>;
  int dev = 0, nsm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const size_t lane = Sh::lane(a.nth);
  const size_t statics = Sh::gs_bytes + up16(sizeof(double) * rest_doubles(a.m, a.n, a.nth));
  if (statics + lane > kBlockSmem) return cudaErrorInvalidValue;
  // a small batch spreads over every SM, a lane a warp
  const int want = std::min(kMaxWarps, std::max(1, (a.B + nsm - 1) / nsm));
  const int warps = std::min(want, static_cast<int>((kBlockSmem - statics) / lane));
  const size_t smem = statics + warps * lane;
  // the attribute is the device's: set it at every launch
  e = cudaFuncSetAttribute(epilogue_kernel<RI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, epilogue_kernel<RI>, 32 * warps,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int blocks = std::min((a.B + warps - 1) / warps, per_sm * nsm);
  a.rest_bytes = static_cast<int>(statics - Sh::gs_bytes);
  a.lane_bytes = static_cast<int>(lane);
  epilogue_kernel<RI><<<blocks, 32 * warps, smem, stream>>>(a, warps);
  return cudaGetLastError();
}

}  // namespace

// Shapes: Gs float32 (m, m); G, Dth (m, nth), du, dl (m,), u_off (n,),
// Uth (n, nth), HinvET (n, m) float64; theta (B, nth), R and R_out
// (B, m, m) float32; act, side (B, m) and done, infeas (B,) one byte each;
// U (B, n) and lam (B, m) float32 out, status (B,) int32 out. Every array
// contiguous, 1 <= m <= 56. Returns the cudaError_t of the launch:
// cudaErrorInvalidValue where the statics leave no room for a lane.
extern "C" int lmpc_iu_epilogue(int m, int n, int nth, int B, const void* Gs, const void* G,
                                const void* Dth, const void* du, const void* dl,
                                const void* u_off, const void* Uth, const void* HinvET,
                                const void* theta, const void* R, const void* act,
                                const void* side, const void* done, const void* infeas,
                                void* U, void* lam, void* R_out, void* status, int refine,
                                double res_tol, void* stream) {
  if (m < 1 || m > 8 * kMaxRI || n < 1 || nth < 0 || B < 1 || refine < 0)
    return cudaErrorInvalidValue;
  Args a{};
  a.m = m;
  a.n = n;
  a.nth = nth;
  a.B = B;
  a.refine = refine;
  a.res_tol = res_tol;
  a.Gs = static_cast<const float*>(Gs);
  a.G = static_cast<const double*>(G);
  a.Dth = static_cast<const double*>(Dth);
  a.du = static_cast<const double*>(du);
  a.dl = static_cast<const double*>(dl);
  a.u_off = static_cast<const double*>(u_off);
  a.Uth = static_cast<const double*>(Uth);
  a.HinvET = static_cast<const double*>(HinvET);
  a.theta = static_cast<const float*>(theta);
  a.R = static_cast<const float*>(R);
  a.act = static_cast<const uint8_t*>(act);
  a.side = static_cast<const uint8_t*>(side);
  a.done = static_cast<const uint8_t*>(done);
  a.infeas = static_cast<const uint8_t*>(infeas);
  a.U = static_cast<float*>(U);
  a.lam = static_cast<float*>(lam);
  a.R_out = static_cast<float*>(R_out);
  a.status = static_cast<int32_t*>(status);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((m + 7) / 8) {
    case 1: return launch<1>(a, s);
    case 2: return launch<2>(a, s);
    case 3: return launch<3>(a, s);
    case 4: return launch<4>(a, s);
    case 5: return launch<5>(a, s);
    case 6: return launch<6>(a, s);
    default: return launch<7>(a, s);
  }
}

