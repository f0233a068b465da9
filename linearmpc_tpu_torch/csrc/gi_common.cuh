// The Goldfarb-Idnani lane loop shared by the kernels K3 (iu.cu) and K4
// (ciu.cu), and its block-level helpers. One thread block runs one lane;
// thread t owns rows t, t+nt, ... of every per-row array, and every
// reduction that decides the next step is exact and ordered:
//
//  * argmin / argmax keep the first hit (lowest index on ties), as the
//    Pallas kernels' first-hit masks and torch.argmin/argmax do;
//  * every dot product and matvec row sums in index order, one product at
//    a time (the library is built with -fmad=false), as the plain torch
//    versions do, so kernel and plain version agree bit for bit. Zero
//    entries of the vector are skipped: they add +-0 and leave every
//    partial sum's value unchanged.
//
// The two kernels differ only in where the carried working-set inverse
// lives. K3 carries the masked inverse R over all m rows (s = m, index k
// is row k, in the working set when the row is active). K4 carries Rw
// over s slots with the int map slot_row[s] (-1 free) and its inverse
// slot_of[m], in place of the Pallas kernel's one-hot (s*m) SEL: an add
// takes the first free slot, a removal frees the row's slot, and a full
// add with every slot occupied sets the lane's overflow flag and ends it.
#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gi {

constexpr int kMaxThreads = 256;
constexpr size_t kSmemLimit = 200 * 1024;

template <typename T>
__device__ __forceinline__ bool better(bool is_min, T ov, int oi, T v, int i) {
  return is_min ? (ov < v || (ov == v && oi < i)) : (ov > v || (ov == v && oi < i));
}

// First-hit arg-reduction over the block. Each thread passes the best
// (value, index) over its own rows (index INT_MAX when it has none); the
// block's best lands in *out_v / *out_i (index clamped to 0 when no row
// qualified). Ends with __syncthreads().
template <typename T>
__device__ void block_arg(bool is_min, T v, int i, T* red_v, int* red_i, T* out_v,
                          int* out_i) {
  for (int o = 16; o > 0; o >>= 1) {
    const T ov = __shfl_down_sync(0xffffffffu, v, o);
    const int oi = __shfl_down_sync(0xffffffffu, i, o);
    if (better(is_min, ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0) {
    red_v[w] = v;
    red_i[w] = i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T bv = red_v[0];
    int bi = red_i[0];
    const int nw = (blockDim.x + 31) >> 5;
    for (int k = 1; k < nw; ++k)
      if (better(is_min, red_v[k], red_i[k], bv, bi)) {
        bv = red_v[k];
        bi = red_i[k];
      }
    *out_v = bv;
    *out_i = bi == INT_MAX ? 0 : bi;
  }
  __syncthreads();
}

// Per-thread first-hit update while scanning rows in increasing order.
template <typename T>
__device__ __forceinline__ void scan(bool is_min, T v, int i, T& bv, int& bi) {
  if (bi == INT_MAX || (is_min ? v < bv : v > bv)) {
    bv = v;
    bi = i;
  }
}

// sum_j row[j * stride] * x[j] over j = 0..n-1 in index order.
template <typename T>
__device__ __forceinline__ T dot(const T* row, int stride, const T* x, int n) {
  T acc = T(0);
  bool any = false;
  for (int j = 0; j < n; ++j) {
    const T xj = x[j];
    if (xj != T(0)) {
      const T p = row[static_cast<size_t>(j) * stride] * xj;
      acc = any ? acc + p : p;
      any = true;
    }
  }
  return acc;
}

// p[0] + p[1] + ... + p[n-1] in index order.
template <typename T>
__device__ __forceinline__ T serial_sum(const T* p, int n) {
  T acc = p[0];
  for (int k = 1; k < n; ++k) acc += p[k];
  return acc;
}

template <typename T>
__device__ __forceinline__ T inf() {
  return static_cast<T>(INFINITY);
}

// One launch of a GI bulk phase. Arrays batch-major: du/dl/lam0 (B, m),
// inv0/inv (B, s, s) row-major, slots0/slots (B, s) int32, bool arrays one
// byte per entry; GT and GsT are G and the GI Gram matrix transposed (m,
// m); eq is (m,) with eq_stride 0 or (B, m) with eq_stride m. The slot
// arrays and ovf are K4's only.
template <typename T>
struct Args {
  int m, s;
  const T* GT;
  const T* GsT;
  const T* du_t;
  const T* dl_t;
  const uint8_t* eq;
  int eq_stride;
  const uint8_t* immut;
  const T* lam0;
  const uint8_t* act0;
  const uint8_t* side0;
  const int32_t* slots0;
  const T* inv0;
  T* lam;
  uint8_t* act;
  uint8_t* side;
  int32_t* iters;
  uint8_t* done;
  uint8_t* infeas;
  uint8_t* ovf;
  int32_t* slots;
  T* inv;
  int max_iter;
  T ptol, stol, gtol, big;
  int retry;
  int inv_in_smem;  // set by launch()
};

// The lane loop of blockIdx.x: until it converges, is flagged infeasible
// (dual-unbounded ray), overflows its slots (K4) or reaches max_iter; with
// retry != 0, a lane flagged from its warm start is reset to a cold start
// (empty set, identity inverse, every slot free) and every lane not done
// runs up to max_iter more iterations (pallas_iu.py:509-523,
// pallas_ciu.py:446-462).
//
// Per iteration: lam* = inv @ rhs; a blocking step when a removable row's
// multiplier has the wrong sign; otherwise the GI step for the most
// violated inactive row (or the pending candidate of a partial step):
// direction inv @ v_j, Schur complement gamma, primal step viol / gamma
// against the first dual blocker ROW; then the rank-2 Woodbury update of
// the inverse at the one index that changed, as a where-select so a det ~ 0
// update cannot poison it (pallas_iu.py:285-289).
template <typename T, bool kSlots>
__device__ __forceinline__ void lane(const Args<T>& a) {
  const int m = a.m, s = a.s;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* lam = reinterpret_cast<T*>(smem_raw);
  T* ls = lam + m;    // lam* in row space
  T* lb = ls + m;     // working point lam_base
  T* c = lb + m;      // G @ lam_base
  T* vup = c + m;
  T* vlo = vup + m;
  T* du = vlo + m;
  T* dl = du + m;
  T* dvr = dl + m;    // GI direction in row space
  T* xw = dvr + m;    // inverse-space vectors: rhs, v_j, v_ch
  T* yw = xw + s;     // inv @ xw
  T* Re = yw + s;     // inv[:, changed index]
  T* p1 = Re + s;
  T* p2 = p1 + s;
  T* Rs = p2 + s;
  int* slot_row = reinterpret_cast<int*>(Rs + (a.inv_in_smem ? s * (s + 1) : 0));
  int* slot_of = slot_row + s;
  uint8_t* act = kSlots ? reinterpret_cast<uint8_t*>(slot_of + m)
                        : reinterpret_cast<uint8_t*>(slot_row);
  uint8_t* side = act + m;
  uint8_t* eq = side + m;
  uint8_t* immut = eq + m;

  // index k of the inverse stands for row row_at(k) (-1: a free slot); row
  // i sits at index index_of(i) (-1: none); index k is in the working set
  // when held(k)
  auto row_at = [&](int k) -> int {
    if constexpr (kSlots) return slot_row[k];
    return k;
  };
  auto index_of = [&](int i) -> int {
    if constexpr (kSlots) return slot_of[i];
    return i;
  };
  auto held = [&](int k) -> bool {
    if constexpr (kSlots) return slot_row[k] >= 0;
    return act[k] != 0;
  };

  __shared__ T red_v[32];
  __shared__ int red_i[32];
  __shared__ T sv_[3];
  __shared__ int si_[3];
  __shared__ T s_gamma, s_a21, s_a22;
  __shared__ int s_pend, s_pend_side, s_done, s_infeas, s_ovf, s_iters, s_nocc, s_nact;

  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const size_t ob = static_cast<size_t>(b) * m;
  const size_t ss = static_cast<size_t>(s) * s;
  T* R = a.inv_in_smem ? Rs : a.inv + b * ss;
  const int ld = a.inv_in_smem ? s + 1 : s;
  const T tiny = T(1e-30), big = a.big;

  if (tid == 0) {
    s_pend = -1;
    s_pend_side = 1;
    s_infeas = 0;
    s_iters = 0;
    s_nocc = 0;
    s_nact = 0;
  }
  for (int e = tid; e < s * s; e += nt) R[(e / s) * ld + e % s] = a.inv0[b * ss + e];
  for (int i = tid; i < m; i += nt) {
    du[i] = a.du_t[ob + i];
    dl[i] = a.dl_t[ob + i];
    act[i] = a.act0[ob + i] != 0;
    side[i] = a.side0[ob + i] != 0;
    lam[i] = act[i] ? a.lam0[ob + i] : T(0);
    eq[i] = a.eq[static_cast<size_t>(b) * a.eq_stride + i] != 0;
    immut[i] = a.immut[i] != 0;
    if constexpr (kSlots) slot_of[i] = -1;
  }
  __syncthreads();
  if constexpr (kSlots) {
    for (int k = tid; k < s; k += nt) {
      const int r = a.slots0[static_cast<size_t>(b) * s + k];
      slot_row[k] = r;
      if (r >= 0) {
        slot_of[r] = k;
        atomicAdd(&s_nocc, 1);
      }
    }
    for (int i = tid; i < m; i += nt)
      if (act[i]) atomicAdd(&s_nact, 1);
    __syncthreads();
  }
  if (tid == 0) {
    s_ovf = kSlots && s_nact > s;  // the entry working set does not fit the slots
    s_done = s_ovf;
  }
  __syncthreads();

  for (int phase = 0; phase < (a.retry ? 2 : 1); ++phase) {
    if (phase == 1) {
      // a ray found from a warm start is not trusted: restart cold
      const bool flag = s_infeas != 0;
      __syncthreads();
      if (flag) {
        for (int i = tid; i < m; i += nt) {
          lam[i] = T(0);
          act[i] = 0;
          side[i] = 1;
          if constexpr (kSlots) slot_of[i] = -1;
        }
        if constexpr (kSlots)
          for (int k = tid; k < s; k += nt) slot_row[k] = -1;
        for (int e = tid; e < s * s; e += nt)
          R[(e / s) * ld + e % s] = (e / s == e % s) ? T(1) : T(0);
        if (tid == 0) {
          s_pend = -1;
          s_done = 0;
          s_infeas = 0;
          s_nocc = 0;
        }
      }
      __syncthreads();
    }
    for (int it = 0; it < a.max_iter; ++it) {
      if (s_done) break;
      const int pend = s_pend;
      const bool pending = pend >= 0;

      // -- jump target lam* = inv @ rhs, read back into row space
      for (int k = tid; k < s; k += nt) {
        const int r = row_at(k);
        xw[k] = (r >= 0 && act[r]) ? -(side[r] ? du[r] : dl[r]) : T(0);
      }
      __syncthreads();
      for (int k = tid; k < s; k += nt) yw[k] = dot(R + k * ld, 1, xw, s);
      __syncthreads();

      // -- sign check (suspended mid-add) and the blocking candidate
      T bv = inf<T>();
      int bi = INT_MAX;
      int any_viol = 0;
      for (int i = tid; i < m; i += nt) {
        const int k = index_of(i);
        const T lsi = k >= 0 ? yw[k] : T(0);
        ls[i] = lsi;
        const bool sv = !pending && act[i] && !eq[i] && (side[i] ? lsi < -a.stol : lsi > a.stol);
        T al = big;
        if (sv) {
          const T den = lam[i] - lsi;
          const T safe = fabs(den) > tiny ? den : tiny;
          al = lam[i] / safe;
          any_viol = 1;
        }
        scan(true, al, i, bv, bi);
        lb[i] = pending ? lam[i] : (act[i] ? lsi : T(0));
      }
      const bool hv = __syncthreads_or(any_viol) != 0;
      block_arg(true, bv, bi, red_v, red_i, &sv_[0], &si_[0]);
      const int jb = si_[0];
      const T alpha = fmin(fmax(sv_[0], T(0)), T(1));

      // -- working point slack c = G @ lam_base and the most violated row
      bv = -inf<T>();
      bi = INT_MAX;
      for (int i = tid; i < m; i += nt) {
        const T ci = dot(a.GT + i, m, lb, m);
        c[i] = ci;
        const bool cand = !act[i] && !immut[i];
        const T u = cand ? -(du[i] + ci) : -big;
        const T l = cand ? dl[i] + ci : -big;
        vup[i] = u;
        vlo[i] = l;
        scan(false, u > l ? u : l, i, bv, bi);
      }
      block_arg(false, bv, bi, red_v, red_i, &sv_[1], &si_[1]);
      const int j_new = si_[1];
      const bool conv = !pending && sv_[1] <= a.ptol;
      const int j_sel = pending ? pend : j_new;
      const bool side_j = pending ? s_pend_side != 0 : vup[j_new] >= vlo[j_new];
      const T viol_j = side_j ? -(du[j_sel] + c[j_sel]) : dl[j_sel] + c[j_sel];
      const bool drop = pending && viol_j <= a.ptol;

      // -- GI step for the candidate: direction inv @ v_j, Schur complement
      const T* gs_j = a.GsT + static_cast<size_t>(j_sel) * m;
      for (int k = tid; k < s; k += nt) {
        const int r = row_at(k);
        xw[k] = (r >= 0 && act[r] && r != j_sel) ? gs_j[r] : T(0);
      }
      __syncthreads();
      for (int k = tid; k < s; k += nt) {
        yw[k] = dot(R + k * ld, 1, xw, s);
        p1[k] = xw[k] * yw[k];
      }
      __syncthreads();
      if (tid == 0) s_gamma = gs_j[j_sel] - serial_sum(p1, s);
      __syncthreads();
      const T gamma = s_gamma;
      const T sgn = side_j ? T(1) : T(-1);
      const T t_primal = gamma > a.gtol
                             ? (viol_j > T(0) ? viol_j : T(0)) / (gamma > a.gtol ? gamma : a.gtol)
                             : big;
      bv = inf<T>();
      bi = INT_MAX;
      for (int i = tid; i < m; i += nt) {
        const int k = index_of(i);
        const T dv = k >= 0 ? sgn * yw[k] : T(0);
        dvr[i] = dv;
        const bool valid = act[i] && !eq[i] && (side[i] ? dv > T(0) : dv < T(0));
        T t = big;
        if (valid) {
          const T q = lb[i] / (dv == T(0) ? T(1) : dv);
          t = q > T(0) ? q : T(0);
        }
        scan(true, t, i, bv, bi);
      }
      block_arg(true, bv, bi, red_v, red_i, &sv_[2], &si_[2]);
      const int ib = si_[2];
      const T t_dual = sv_[2];
      const bool full_add = t_primal <= t_dual;
      const T t_step = t_primal < t_dual ? t_primal : t_dual;
      const bool live = !hv && !conv && !drop;
      const bool no_step = t_step >= big;
      bool full = false;  // a full add with no free slot
      if constexpr (kSlots) full = full_add && s_nocc >= s;
      const bool infeas_now = live && no_step;
      const bool ovf_now = live && !no_step && full;
      const bool take = live && !no_step && !full;

      // -- new row state
      const T lb_j = lb[j_sel];
      for (int i = tid; i < m; i += nt) {
        T nl;
        uint8_t na, ns = side[i];
        if (hv) {
          nl = (i == jb) ? T(0) : lam[i] + alpha * (ls[i] - lam[i]);
          na = act[i] && i != jb;
        } else if (take) {
          nl = act[i] ? lb[i] - t_step * dvr[i] : lb[i];
          if (i == j_sel) nl = lb_j + sgn * t_step;
          if (i == ib && !full_add) nl = T(0);
          na = full_add ? (act[i] || i == j_sel) : (act[i] && i != ib);
          if (full_add && i == j_sel) ns = side_j;
        } else {
          nl = drop ? (i == j_sel ? T(0) : lam[i]) : lb[i];
          na = act[i];
        }
        lam[i] = nl;
        act[i] = na;
        side[i] = ns;
      }
      // the changed row and its inverse index sc: K4's removal frees the
      // row's slot, its add takes the first free one
      const bool is_rem = hv || (take && !full_add);
      const int ch = hv ? jb : (full_add ? j_sel : ib);
      int sc = -1;
      if (hv || take) {
        if constexpr (kSlots) {
          if (is_rem) {
            sc = slot_of[ch];
          } else {
            for (int k = 0; k < s; ++k)
              if (slot_row[k] < 0) {
                sc = k;
                break;
              }
          }
        } else {
          sc = ch;
        }
      }
      __syncthreads();
      if (tid == 0) {
        s_pend = (take && !full_add) ? j_sel : ((take || drop) ? -1 : pend);
        if (take) s_pend_side = side_j;
        s_done = (!hv && conv) || infeas_now || ovf_now;
        s_infeas = s_infeas || infeas_now;
        s_ovf = s_ovf || ovf_now;
        s_iters += 1;
        if constexpr (kSlots) {
          if (sc >= 0) {
            if (is_rem) {
              slot_row[sc] = -1;
              slot_of[ch] = -1;
              s_nocc -= 1;
            } else {
              slot_row[sc] = ch;
              slot_of[ch] = sc;
              s_nocc += 1;
            }
          }
        }
      }

      // -- rank-2 Woodbury update of the inverse at sc, the changed row's
      //    Gram column gathered through the updated working set
      if (sc >= 0) {
        const T* gs_c = a.GsT + static_cast<size_t>(ch) * m;
        __syncthreads();
        for (int k = tid; k < s; k += nt) {
          xw[k] = (held(k) && k != sc) ? gs_c[row_at(k)] : T(0);
          Re[k] = R[k * ld + sc];
        }
        __syncthreads();
        for (int k = tid; k < s; k += nt) {
          yw[k] = dot(R + k * ld, 1, xw, s);
          p1[k] = xw[k] * Re[k];
          p2[k] = xw[k] * yw[k];
        }
        __syncthreads();
        if (tid == 0) s_a21 = serial_sum(p1, s);
        if (tid == (nt > 32 ? 32 : 0)) s_a22 = serial_sum(p2, s);
        __syncthreads();
        const T a11 = Re[sc], a12 = yw[sc], a21 = s_a21, a22 = s_a22, gjj = gs_c[ch];
        const T S00 = is_rem ? -a11 : a11;
        const T S01 = is_rem ? T(1) - a12 : T(1) + a12;
        const T S10 = is_rem ? T(1) - a21 : T(1) + a21;
        const T S11 = is_rem ? (T(1) - gjj) - a22 : (T(1) - gjj) + a22;
        T det = S00 * S11 - S01 * S10;
        det = fabs(det) > tiny ? det : tiny;
        for (int k = tid; k < s; k += nt) {
          const T t0 = (S11 * Re[k] - S10 * yw[k]) / det;
          const T t1 = (-S01 * Re[k] + S00 * yw[k]) / det;
          T* Rk = R + k * ld;
          for (int j = 0; j < s; ++j) {
            const T u = t0 * Re[j] + t1 * yw[j];
            Rk[j] = is_rem ? Rk[j] + u : Rk[j] - u;
          }
        }
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < m; i += nt) {
    a.lam[ob + i] = lam[i];
    a.act[ob + i] = act[i];
    a.side[ob + i] = side[i];
  }
  if constexpr (kSlots)
    for (int k = tid; k < s; k += nt) a.slots[static_cast<size_t>(b) * s + k] = slot_row[k];
  if (a.inv_in_smem)
    for (int e = tid; e < s * s; e += nt) a.inv[b * ss + e] = R[(e / s) * ld + e % s];
  if (tid == 0) {
    a.iters[b] = s_iters;
    a.done[b] = s_done;
    a.infeas[b] = s_infeas;
    if constexpr (kSlots) a.ovf[b] = s_ovf;
  }
}

// Launch ``kernel`` (one block per lane) with the inverse in shared memory
// when the block's arrays fit kSmemLimit together with it (rows padded to
// an odd stride, so the row-per-thread matvecs are free of bank
// conflicts); otherwise the kernel updates it in place in the output.
template <typename T, bool kSlots>
cudaError_t launch(void (*kernel)(Args<T>), Args<T> a, int B, cudaStream_t stream) {
  const size_t vec_bytes = sizeof(T) * (9 * a.m + 5 * a.s) +
                           (kSlots ? sizeof(int) * (a.s + a.m) : 0) + 4 * a.m + 16;
  const size_t inv_bytes = sizeof(T) * a.s * (a.s + 1);
  a.inv_in_smem = vec_bytes + inv_bytes <= kSmemLimit;
  const size_t smem = vec_bytes + (a.inv_in_smem ? inv_bytes : 0);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int threads = a.m >= kMaxThreads ? kMaxThreads : ((a.m + 31) / 32) * 32;
  kernel<<<B, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace gi
