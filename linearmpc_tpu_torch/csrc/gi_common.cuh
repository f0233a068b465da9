// The Goldfarb-Idnani lane loop shared by the kernels K3 (iu.cu), K4
// (ciu.cu) and K3's branch-and-bound search entry (inc_search.cu), built
// for Hopper: a team of NT threads runs one lane. NT is one warp wherever
// the lane's inverse fits in shared memory and s <= 64, so a block holds
// several lanes, every barrier is a __syncwarp and a lane that
// finishes takes the next one from a work counter without waiting for the
// rest of its block. Above that (the f64 guard ladder at s = 96-192, K3 at
// m = 160 with R in global memory) the same loop runs with a 128-thread
// team, one lane per block. Thread t of a team owns rows t, t+NT, ... of
// every per-row array and of the inverse. Every reduction that decides a
// step is exact and ordered:
//
//  * argmin / argmax keep the first hit (lowest index on ties), as the
//    Pallas kernels' first-hit masks and torch.argmin/argmax do, and a NaN
//    wins as in torch (the first NaN): each thread scans its rows in order,
//    then a shuffle tree combines the warp. Clamps, maxima and minima pass
//    NaN on as torch's do, so a lane whose arithmetic breaks down follows
//    the plain version step for step;
//  * every dot product and matvec row sums in index order, one product at
//    a time (the library is built with -fmad=false), as the plain torch
//    versions do, so kernel and plain version agree bit for bit. The sums
//    run over the ascending list of the vector's nonzero entries (one bit
//    mask word per 32 entries, built by a warp ballot, walked with __ffs): a
//    zero entry adds +-0 and leaves every partial sum's value unchanged, so
//    the list drops no term that counts and there is no branch per term.
//    A thread carries up to kRows rows through one walk of the list, so
//    their products are independent and overlap in the pipeline. Once the
//    carried inverse holds a value that is not finite (0 * inf is NaN), the
//    lists take every index.
//
// The two kernels differ only in where the carried working-set inverse
// lives. K3 carries the masked inverse R over all m rows (s = m, index k
// is row k, in the working set when the row is active). K4 carries Rw
// over s slots with the int map slot_row[s] (-1 free), its inverse
// slot_of[m] and a free-slot bit mask, in place of the Pallas kernel's
// one-hot (s*m) SEL: an add takes the first free slot (__ffs of the mask),
// a removal frees the row's slot, and a full add with every slot occupied
// sets the lane's overflow flag and ends it.
#pragma once

#include <algorithm>
#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gi {

constexpr int kWide = 128;                // threads of a wide team
constexpr int kMaxLanesPerBlock = 16;     // warps (lanes) of a narrow block
constexpr int kRows = 2;                  // rows a thread carries through one list walk
constexpr size_t kInvLimit = 200 * 1024;  // one lane's arrays with its inverse
// a block's dynamic shared memory: sm_90's 232448 bytes less room for the
// kernel's static shared variables
constexpr size_t kBlockSmem = 232448 - 1024;
constexpr unsigned kFull = 0xffffffffu;

// (ov, oi) beats (v, i) in torch's arg-reduction order: a NaN first, then
// the smaller (is_min) or larger value, the lower index on ties.
template <typename T>
__device__ __forceinline__ bool better(bool is_min, T ov, int oi, T v, int i) {
  if (isnan(ov)) return !isnan(v) || oi < i;
  if (isnan(v)) return false;
  return ov == v ? oi < i : (is_min ? ov < v : ov > v);
}

// Per-thread first-hit update while scanning rows in increasing order.
template <typename T>
__device__ __forceinline__ void scan(bool is_min, T v, int i, T& bv, int& bi) {
  if (bi == INT_MAX || better(is_min, v, i, bv, bi)) {
    bv = v;
    bi = i;
  }
}

// torch.maximum / torch.minimum / clamp_min: NaN passes through.
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return isnan(a) ? a : (isnan(b) ? b : (a > b ? a : b));
}
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return isnan(a) ? a : (isnan(b) ? b : (a < b ? a : b));
}
template <typename T>
__device__ __forceinline__ T clamp_min0(T a) {
  return (a > T(0) || isnan(a)) ? a : T(0);
}

template <int NT>
__device__ __forceinline__ void team_sync() {
  if constexpr (NT == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

template <int NT>
__device__ __forceinline__ bool team_any(int p) {
  if constexpr (NT == 32) {
    return __any_sync(kFull, p) != 0;
  } else {
    return __syncthreads_or(p) != 0;
  }
}

// First-hit arg-reduction over the team. Each thread passes the best
// (value, index) over its own rows (index INT_MAX when it has none); every
// thread gets the team's best (index clamped to 0 when no row qualified).
template <int NT, typename T>
__device__ __forceinline__ void team_arg(bool is_min, T& v, int& i, T* red_v, int* red_i) {
  for (int o = 16; o > 0; o >>= 1) {
    const T ov = __shfl_down_sync(kFull, v, o);
    const int oi = __shfl_down_sync(kFull, i, o);
    if (better(is_min, ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  v = __shfl_sync(kFull, v, 0);
  i = __shfl_sync(kFull, i, 0);
  if constexpr (NT > 32) {
    const int w = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      red_v[w] = v;
      red_i[w] = i;
    }
    __syncthreads();
    v = red_v[0];
    i = red_i[0];
    for (int k = 1; k < NT / 32; ++k)
      if (better(is_min, red_v[k], red_i[k], v, i)) {
        v = red_v[k];
        i = red_i[k];
      }
    __syncthreads();
  }
  if (i == INT_MAX) i = 0;
}

template <int NT>
__device__ __forceinline__ int team_sum(int v, int* red_i) {
  v = __reduce_add_sync(kFull, v);
  if constexpr (NT > 32) {
    if ((threadIdx.x & 31) == 0) red_i[threadIdx.x >> 5] = v;
    __syncthreads();
    v = 0;
    for (int k = 0; k < NT / 32; ++k) v += red_i[k];
    __syncthreads();
  }
  return v;
}

// Word w of the mask of every index below n.
__device__ __forceinline__ unsigned all_bits(int w, int n) {
  const int r = n - (w << 5);
  return r >= 32 ? kFull : ((1u << r) - 1u);
}

// The ascending list of a vector's nonzero entries is kept as a bit set,
// one word per 32 indices (built by a warp ballot) and walked with __ffs.

// out[k] = sum of A[k * rs + j * cs] * x[j] over the list mx (ascending j),
// for the team's rows k = tid, tid + NT, ... < n. kRows rows share one walk
// of the list, so their products are independent and overlap.
template <typename T, int NT>
__device__ __forceinline__ void matvec_nz(T* out, const T* A, int rs, int cs, const T* x,
                                          const unsigned* mx, int nw, int n, int tid) {
  for (int k0 = tid; k0 < n; k0 += NT * kRows) {
    T acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = T(0);
    bool any = false;
    for (int w = 0; w < nw; ++w) {
      unsigned bits = mx[w];
      while (bits) {
        const int j = (w << 5) + __ffs(bits) - 1;
        bits &= bits - 1;
        const T xj = x[j];
        const T* col = A + static_cast<size_t>(j) * cs;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int k = k0 + r * NT;
          if (k < n) {
            const T p = col[static_cast<size_t>(k) * rs] * xj;
            acc[r] = any ? acc[r] + p : p;
          }
        }
        any = true;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int k = k0 + r * NT;
      if (k < n) out[k] = acc[r];
    }
  }
}

// sum of a[j] * b[j] over the list mx, ascending.
template <typename T>
__device__ __forceinline__ T dot_nz(const T* a, const T* b, const unsigned* mx, int nw) {
  T acc = T(0);
  bool any = false;
  for (int w = 0; w < nw; ++w) {
    unsigned bits = mx[w];
    while (bits) {
      const int j = (w << 5) + __ffs(bits) - 1;
      bits &= bits - 1;
      const T p = a[j] * b[j];
      acc = any ? acc + p : p;
      any = true;
    }
  }
  return acc;
}

// (sum of a[j] * b[j], sum of a[j] * c[j]) over the list mx, ascending: two
// independent serial sums in one walk.
template <typename T>
__device__ __forceinline__ void dot2_nz(const T* a, const T* b, const T* c, const unsigned* mx,
                                        int nw, T& sb, T& sc) {
  T ab = T(0), ac = T(0);
  bool any = false;
  for (int w = 0; w < nw; ++w) {
    unsigned bits = mx[w];
    while (bits) {
      const int j = (w << 5) + __ffs(bits) - 1;
      bits &= bits - 1;
      const T aj = a[j];
      const T pb = aj * b[j], pc = aj * c[j];
      ab = any ? ab + pb : pb;
      ac = any ? ac + pc : pc;
      any = true;
    }
  }
  sb = ab;
  sc = ac;
}

template <typename T>
__device__ __forceinline__ T inf() {
  return static_cast<T>(INFINITY);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The s x s inverse between the dense row-major g and R (leading dimension
// ld): kOut = false copies g into R, true copies R into g. Thread tid takes
// 16-byte vectors tid, tid + nt, ... of g where it is aligned (single
// elements otherwise), kBatch of them in flight at a time; the (row,
// column) of R advances incrementally, with no division per element.
// Returns whether this thread copied a value that is not finite.
template <typename T, bool kOut>
__device__ __forceinline__ int copy_inv(T* R, int ld, T* g, int s, int tid, int nt) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kBatch = 4;
  int nonfinite = 0;
  union Vec {
    float4 v;
    T t[V];
  };
  const int n = s * s;
  const int w = (aligned16(g) && n % V == 0) ? V : 1;
  const int step = nt * w;
  const int dk = step / s, dj = step - dk * s;
  int e = tid * w;
  int k = e / s, j = e - k * s;
  for (; e < n; e += kBatch * step) {
    Vec buf[kBatch];
    int ks[kBatch], js[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int eu = e + u * step;
      ks[u] = k;
      js[u] = j;
      if (!kOut && eu < n) {
        if (w == V) {
          buf[u].v = *reinterpret_cast<const float4*>(g + eu);
        } else {
          buf[u].t[0] = g[eu];
        }
      }
      j += dj;
      k += dk;
      if (j >= s) {
        j -= s;
        ++k;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int eu = e + u * step;
      if (eu >= n) continue;
      int kk = ks[u], jj = js[u];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (v < w) {
          if (kOut) {
            buf[u].t[v] = R[kk * ld + jj];
          } else {
            R[kk * ld + jj] = buf[u].t[v];
            nonfinite |= !isfinite(buf[u].t[v]);
          }
          if (++jj == s) {
            jj = 0;
            ++kk;
          }
        }
      }
      if (kOut) {
        if (w == V) {
          *reinterpret_cast<float4*>(g + eu) = buf[u].v;
        } else {
          g[eu] = buf[u].t[0];
        }
      }
    }
  }
  return nonfinite;
}

// R = I over the s x s inverse (the cold start of the warm-ray retry).
template <typename T>
__device__ __forceinline__ void set_identity(T* R, int ld, int s, int tid, int nt) {
  for (int k = tid; k < s; k += nt)
    for (int j = 0; j < s; ++j) R[k * ld + j] = (k == j) ? T(1) : T(0);
}

// One launch of a GI bulk phase. Arrays batch-major: du/dl/lam0 (B, m),
// inv (B, s, s) row-major, inv0 the same with batch stride inv0_stride (0:
// one (s, s) entry inverse shared by every lane), slots0/slots (B, s)
// int32, bool arrays one byte per entry; GT and GsT are G and the GI Gram
// matrix transposed (m, m); eq is (m,) with eq_stride 0 or (B, m) with
// eq_stride m; work is one int the launch zeroes and the teams count lanes
// on. The slot arrays and ovf are K4's only.
template <typename T>
struct Args {
  int m, s, B;
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
  long long inv0_stride;
  T* lam;
  uint8_t* act;
  uint8_t* side;
  int32_t* iters;
  uint8_t* done;
  uint8_t* infeas;
  uint8_t* ovf;
  int32_t* slots;
  T* inv;
  int* work;
  int max_iter;
  T ptol, stol, gtol, big;
  int retry;
  // K3's resumable entry (null elsewhere): the pending candidate row (-1
  // none) and its side, done and infeas of each lane come in and the first
  // two go out; lam0 is taken as it is (a pending row's partial multiplier
  // sits on an inactive row), and a lane that enters done runs no iteration
  const int32_t* pend0;
  const uint8_t* pside0;
  const uint8_t* done0;
  const uint8_t* infeas0;
  int32_t* pend;
  uint8_t* pside;
  // shared-memory bytes a lane needs beyond lane_bytes() (the search
  // entry's node stack and snapshot; 0 elsewhere)
  int extra_bytes;
  // set by launch()
  int inv_in_smem;
  int g_staged;  // 0: G and G_solve read through L2, 1: G in shared memory, 2: both
  int lane_bytes;
};

__host__ __device__ __forceinline__ size_t up16(size_t x) { return (x + 15) & ~size_t(15); }

// What the last launch on this host thread chose: threads a lane (32 or
// kWide), lanes a block, blocks, the matrices staged in shared memory, the
// inverse in shared memory, and dynamic shared memory bytes a block.
struct Plan {
  int team, lanes, blocks, g_staged, inv_in_smem, smem;
};
inline thread_local Plan last_plan{};

// Shared-memory bytes of one lane, in the order lane() carves them: 9 row
// vectors and 5 inverse-space vectors, the inverse where it lives there
// (rows padded to an odd stride, so the row-per-thread matvecs are free of
// bank conflicts), the wide team's reduction scratch, K4's slot maps, the
// index lists of xw, lam_base and the update's support and K4's free slots
// (one bit per index), and four byte flags per row.
template <typename T, bool kSlots>
__host__ __device__ __forceinline__ size_t lane_bytes(int m, int s, bool inv_in_smem) {
  const size_t nwm = (m + 31) / 32, nws = (s + 31) / 32;
  return up16(sizeof(T) * (9 * m + 5 * s + (inv_in_smem ? s * (s + 1) : 0) + 4) +
              sizeof(int) * (4 + (kSlots ? s + m : 0)) + 4 * (3 * nws + nwm) + 4 * m);
}

// One lane's state and its GI loop, in three pieces that K3, K4 and K3's
// branch-and-bound search entry (inc_search.cu) call: load() enters the
// lane from global memory, iterate() runs up to max_iter iterations on
// what lives in shared memory and registers, store() writes the lane out.
// The search keeps a Lane across its rounds and edits its bounds, eq rows,
// multipliers and inverse in place between iterate() calls.
//
// Per iteration: lam* = inv @ rhs; a blocking step when a removable row's
// multiplier has the wrong sign; otherwise the GI step for the most
// violated inactive row (or the pending candidate of a partial step):
// direction inv @ v_j, Schur complement gamma, primal step viol / gamma
// against the first dual blocker ROW; then the rank-2 Woodbury update of
// the inverse at the one index that changed, as a where-select so a det ~ 0
// update cannot poison it (pallas_iu.py:285-289). Every product walks the
// ascending list of its vector's nonzero entries. The update touches only
// the rows and columns where the changed column or the new product is
// nonzero: elsewhere it adds +-0. Where a factor of it is not finite it
// runs over the whole inverse, so NaN and inf spread as in the plain one.
template <typename T, bool kSlots, int NT>
struct Lane {
  int m, s, tid, ln, wid, nwm, nws, ld;
  T *lam, *ls, *lb, *c, *vup, *vlo, *du, *dl, *dvr, *xw, *yw, *Re, *t0s, *t1s, *R, *red_v;
  int *red_i, *slot_row, *slot_of;
  unsigned *mx, *mb, *msup, *mfree;
  uint8_t *act, *side, *eq, *immut;
  // dense: the inverse holds a value that is not finite, so a zero entry of
  // the vector it multiplies counts too (0 * inf is NaN)
  bool dense;
  int nocc;  // occupied slots (K4)
  int ovf, done, infeas, pend, pend_side;

  // Carve lane b's arrays out of its shared memory at base, in the order
  // lane_bytes() counts them.
  __device__ __forceinline__ Lane(const Args<T>& a, int b, unsigned char* base)
      : dense(false), nocc(0), ovf(0), done(0), infeas(0), pend(-1), pend_side(1) {
    m = a.m;
    s = a.s;
    tid = NT == 32 ? (threadIdx.x & 31) : threadIdx.x;
    ln = threadIdx.x & 31;
    wid = NT == 32 ? 0 : (threadIdx.x >> 5);
    nwm = (m + 31) >> 5;
    nws = (s + 31) >> 5;
    lam = reinterpret_cast<T*>(base);
    ls = lam + m;    // lam* in row space
    lb = ls + m;     // working point lam_base
    c = lb + m;      // G @ lam_base
    vup = c + m;
    vlo = vup + m;
    du = vlo + m;
    dl = du + m;
    dvr = dl + m;    // GI direction in row space
    xw = dvr + m;    // inverse-space vectors: rhs, v_j, v_ch
    yw = xw + s;     // inv @ xw
    Re = yw + s;     // inv[:, changed index]
    t0s = Re + s;    // the Woodbury factors of each row
    t1s = t0s + s;
    T* Rs = t1s + s;
    red_v = Rs + (a.inv_in_smem ? s * (s + 1) : 0);
    red_i = reinterpret_cast<int*>(red_v + 4);
    slot_row = red_i + 4;
    slot_of = slot_row + (kSlots ? s : 0);
    mx = reinterpret_cast<unsigned*>(slot_of + (kSlots ? m : 0));  // xw's list
    mb = mx + nws;       // lam_base's list
    msup = mb + nwm;     // the update's support: Re != 0 or yw != 0
    mfree = msup + nws;  // free slots (K4)
    act = reinterpret_cast<uint8_t*>(mfree + nws);
    side = act + m;
    eq = side + m;
    immut = eq + m;
    const size_t ss = static_cast<size_t>(s) * s;
    R = a.inv_in_smem ? Rs : a.inv + b * ss;
    ld = a.inv_in_smem ? s + 1 : s;
  }

  // index k of the inverse stands for row row_at(k) (-1: a free slot); row
  // i sits at index index_of(i) (-1: none); index k is in the working set
  // when held(k)
  __device__ __forceinline__ int row_at(int k) const {
    if constexpr (kSlots) return slot_row[k];
    return k;
  }
  __device__ __forceinline__ int index_of(int i) const {
    if constexpr (kSlots) return slot_of[i];
    return i;
  }
  __device__ __forceinline__ bool held(int k) const {
    if constexpr (kSlots) return slot_row[k] >= 0;
    return act[k] != 0;
  }
  // the list of the k < n where pred(k): one ballot word per 32 indices,
  // over this warp's chunks; pred(k) reads what the thread that owns k wrote
  template <typename P>
  __device__ __forceinline__ void ballots(int n, unsigned* mask, P&& pred) const {
    for (int k0 = wid * 32; k0 < n; k0 += NT) {
      const unsigned word = __ballot_sync(kFull, k0 + ln < n && pred(k0 + ln));
      if (ln == 0) mask[k0 >> 5] = word;
    }
  }
  __device__ __forceinline__ void list_xw() {
    ballots(s, mx, [&](int k) { return dense || xw[k] != T(0); });
    team_sync<NT>();
  }

  // Enter lane b from global memory: its entry inverse, rows, slots (K4)
  // and, at K3's resumable entry (pend0 set), its pending row and side,
  // done and infeas.
  __device__ __forceinline__ void load(const Args<T>& a, int b) {
    const size_t ob = static_cast<size_t>(b) * m;
    const bool resume = a.pend0 != nullptr;
    const int inv0_nonfinite =
        copy_inv<T, false>(R, ld, const_cast<T*>(a.inv0 + b * a.inv0_stride), s, tid, NT);
    // the lane's rows: kRows rows' loads in flight before their stores
    int nact = 0;
    for (int i0 = tid; i0 < m; i0 += NT * kRows) {
      T r_du[kRows], r_dl[kRows], r_l0[kRows];
      uint8_t r_a[kRows], r_s[kRows], r_e[kRows], r_im[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = i0 + r * NT;
        if (i < m) {
          r_du[r] = a.du_t[ob + i];
          r_dl[r] = a.dl_t[ob + i];
          r_l0[r] = a.lam0[ob + i];
          r_a[r] = a.act0[ob + i];
          r_s[r] = a.side0[ob + i];
          r_e[r] = a.eq[static_cast<size_t>(b) * a.eq_stride + i];
          r_im[r] = a.immut[i];
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = i0 + r * NT;
        if (i < m) {
          du[i] = r_du[r];
          dl[i] = r_dl[r];
          act[i] = r_a[r] != 0;
          side[i] = r_s[r] != 0;
          lam[i] = (r_a[r] || resume) ? r_l0[r] : T(0);
          eq[i] = r_e[r] != 0;
          immut[i] = r_im[r] != 0;
          nact += r_a[r] != 0;
          if constexpr (kSlots) slot_of[i] = -1;
        }
      }
    }
    if constexpr (kSlots) {
      nact = team_sum<NT>(nact, red_i);
      team_sync<NT>();
      for (int k = tid; k < s; k += NT) {
        const int r = a.slots0[static_cast<size_t>(b) * s + k];
        slot_row[k] = r;
        if (r >= 0) slot_of[r] = k;
        nocc += r >= 0;
      }
      ballots(s, mfree, [&](int k) { return slot_row[k] < 0; });
      nocc = team_sum<NT>(nocc, red_i);
    }
    team_sync<NT>();

    dense = team_any<NT>(inv0_nonfinite);
    ovf = kSlots && nact > s;  // the entry working set does not fit the slots
    done = ovf;
    if (resume) {
      pend = a.pend0[b];
      pend_side = a.pside0[b] != 0;
      done = a.done0[b] != 0;
      infeas = a.infeas0[b] != 0;
    }
  }

  // A cold start: empty working set, identity inverse, every slot free, no
  // pending row (the warm-ray retry).
  __device__ __forceinline__ void cold_reset() {
    for (int i = tid; i < m; i += NT) {
      lam[i] = T(0);
      act[i] = 0;
      side[i] = 1;
      if constexpr (kSlots) slot_of[i] = -1;
    }
    if constexpr (kSlots) {
      for (int k = tid; k < s; k += NT) slot_row[k] = -1;
      for (int w = tid; w < nws; w += NT) mfree[w] = all_bits(w, s);
    }
    set_identity(R, ld, s, tid, NT);
    dense = false;
    pend = -1;
    done = 0;
    infeas = 0;
    nocc = 0;
    team_sync<NT>();
  }

  // Up to max_iter iterations, until the lane converges, is flagged
  // infeasible (dual-unbounded ray) or overflows its slots (K4); a lane
  // that enters done runs none. Returns the iterations run.
  __device__ __forceinline__ int iterate(const Args<T>& a, const T* GT, const T* GsT,
                                         int max_iter) {
    const T tiny = T(1e-30), big = a.big;
    int iters = 0;
    for (int it = 0; it < max_iter; ++it) {
      if (done) break;
      const bool pending = pend >= 0;

      // -- jump target lam* = inv @ rhs, read back into row space
      for (int k = tid; k < s; k += NT) {
        const int r = row_at(k);
        xw[k] = (r >= 0 && act[r]) ? -(side[r] ? du[r] : dl[r]) : T(0);
      }
      list_xw();
      matvec_nz<T, NT>(yw, R, ld, 1, xw, mx, nws, s, tid);
      team_sync<NT>();

      // -- sign check (suspended mid-add), the blocking candidate and the
      //    working point lam_base
      T bvv = inf<T>();
      int bii = INT_MAX;
      int any_viol = 0;
      for (int i = tid; i < m; i += NT) {
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
        scan(true, al, i, bvv, bii);
        lb[i] = pending ? lam[i] : (act[i] ? lsi : T(0));
      }
      const bool hv = team_any<NT>(any_viol);
      team_arg<NT>(true, bvv, bii, red_v, red_i);
      const int jb = bii;
      const T alpha = isnan(bvv) ? bvv : fmin(fmax(bvv, T(0)), T(1));

      // -- working point slack c = G @ lam_base and the most violated row
      ballots(m, mb, [&](int i) { return lb[i] != T(0); });
      team_sync<NT>();
      matvec_nz<T, NT>(c, GT, 1, m, lb, mb, nwm, m, tid);
      bvv = -inf<T>();
      bii = INT_MAX;
      for (int i = tid; i < m; i += NT) {
        const T ci = c[i];
        const bool cand = !act[i] && !immut[i];
        const T u = cand ? -(du[i] + ci) : -big;
        const T l = cand ? dl[i] + ci : -big;
        vup[i] = u;
        vlo[i] = l;
        scan(false, nan_max(u, l), i, bvv, bii);
      }
      team_arg<NT>(false, bvv, bii, red_v, red_i);
      team_sync<NT>();
      const int j_new = bii;
      const bool conv = !pending && bvv <= a.ptol;
      const int j_sel = pending ? pend : j_new;
      const bool side_j = pending ? pend_side != 0 : vup[j_new] >= vlo[j_new];
      const T viol_j = side_j ? -(du[j_sel] + c[j_sel]) : dl[j_sel] + c[j_sel];
      const bool drop = pending && viol_j <= a.ptol;

      // -- GI step for the candidate: direction inv @ v_j, Schur complement
      const T* gs_j = GsT + static_cast<size_t>(j_sel) * m;
      for (int k = tid; k < s; k += NT) {
        const int r = row_at(k);
        xw[k] = (r >= 0 && act[r] && r != j_sel) ? gs_j[r] : T(0);
      }
      list_xw();
      matvec_nz<T, NT>(yw, R, ld, 1, xw, mx, nws, s, tid);
      team_sync<NT>();
      const T gamma = gs_j[j_sel] - dot_nz(xw, yw, mx, nws);
      const T sgn = side_j ? T(1) : T(-1);
      const T t_primal = gamma > a.gtol ? clamp_min0(viol_j) / gamma : big;
      bvv = inf<T>();
      bii = INT_MAX;
      for (int i = tid; i < m; i += NT) {
        const int k = index_of(i);
        const T dv = k >= 0 ? sgn * yw[k] : T(0);
        dvr[i] = dv;
        const bool valid = act[i] && !eq[i] && (side[i] ? dv > T(0) : dv < T(0));
        T t = big;
        if (valid) {
          t = clamp_min0(lb[i] / (dv == T(0) ? T(1) : dv));
        }
        scan(true, t, i, bvv, bii);
      }
      team_arg<NT>(true, bvv, bii, red_v, red_i);
      const int ib = bii;
      const T t_dual = bvv;
      const bool full_add = t_primal <= t_dual;
      const T t_step = nan_min(t_primal, t_dual);
      const bool live = !hv && !conv && !drop;
      const bool no_step = t_step >= big;
      bool full = false;  // a full add with no free slot
      if constexpr (kSlots) full = full_add && nocc >= s;
      const bool infeas_now = live && no_step;
      const bool ovf_now = live && !no_step && full;
      const bool take = live && !no_step && !full;

      // -- new row state
      const T lb_j = lb[j_sel];
      for (int i = tid; i < m; i += NT) {
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
            for (int w = 0; w < nws && sc < 0; ++w)
              if (mfree[w]) sc = (w << 5) + __ffs(mfree[w]) - 1;
          }
        } else {
          sc = ch;
        }
      }
      pend = (take && !full_add) ? j_sel : ((take || drop) ? -1 : pend);
      if (take) pend_side = side_j;
      done = (!hv && conv) || infeas_now || ovf_now;
      infeas = infeas || infeas_now;
      ovf = ovf || ovf_now;
      iters += 1;
      team_sync<NT>();
      if constexpr (kSlots) {
        if (sc >= 0) {
          if (tid == 0) {
            if (is_rem) {
              slot_row[sc] = -1;
              slot_of[ch] = -1;
              mfree[sc >> 5] |= 1u << (sc & 31);
            } else {
              slot_row[sc] = ch;
              slot_of[ch] = sc;
              mfree[sc >> 5] &= ~(1u << (sc & 31));
            }
          }
          nocc += is_rem ? -1 : 1;
          team_sync<NT>();
        }
      }

      // -- rank-2 Woodbury update of the inverse at sc, the changed row's
      //    Gram column gathered through the updated working set. On a full
      //    add that column is the GI step's v_j (the working set the step
      //    saw, the new row left out), so its list and inv @ v_j carry over.
      if (sc >= 0) {
        const T* gs_c = GsT + static_cast<size_t>(ch) * m;
        if (is_rem) {
          for (int k = tid; k < s; k += NT) {
            xw[k] = (held(k) && k != sc) ? gs_c[row_at(k)] : T(0);
            Re[k] = R[k * ld + sc];
          }
          list_xw();
          matvec_nz<T, NT>(yw, R, ld, 1, xw, mx, nws, s, tid);
        } else {
          for (int k = tid; k < s; k += NT) Re[k] = R[k * ld + sc];
        }
        ballots(s, msup, [&](int k) { return Re[k] != T(0) || yw[k] != T(0); });
        team_sync<NT>();
        T a21, a22;
        dot2_nz(xw, Re, yw, mx, nws, a21, a22);
        const T a11 = Re[sc], a12 = yw[sc], gjj = gs_c[ch];
        const T S00 = is_rem ? -a11 : a11;
        const T S01 = is_rem ? T(1) - a12 : T(1) + a12;
        const T S10 = is_rem ? T(1) - a21 : T(1) + a21;
        const T S11 = is_rem ? (T(1) - gjj) - a22 : (T(1) - gjj) + a22;
        T det = S00 * S11 - S01 * S10;
        det = fabs(det) > tiny ? det : tiny;
        int nonfinite = !(isfinite(S00) && isfinite(S01) && isfinite(S10) && isfinite(S11) &&
                          isfinite(det));
        for (int k = tid; k < s; k += NT) {
          const T t0 = (S11 * Re[k] - S10 * yw[k]) / det;
          const T t1 = (-S01 * Re[k] + S00 * yw[k]) / det;
          t0s[k] = t0;
          t1s[k] = t1;
          if (Re[k] != T(0) || yw[k] != T(0))
            nonfinite |= !(isfinite(Re[k]) && isfinite(yw[k]) && isfinite(t0) && isfinite(t1));
        }
        // rows and columns outside the support change by +-0 unless a
        // factor is not finite: then the whole inverse takes the update
        const bool whole = team_any<NT>(nonfinite);
        int now_nonfinite = 0;
        for (int k0 = tid; k0 < s; k0 += NT * kRows) {
          bool on[kRows];
          T t0[kRows], t1[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const int k = k0 + r * NT;
            on[r] = k < s && (whole || Re[k] != T(0) || yw[k] != T(0));
            t0[r] = on[r] ? t0s[k] : T(0);
            t1[r] = on[r] ? t1s[k] : T(0);
          }
          if (whole) {
            for (int j = 0; j < s; ++j) {
              const T rj = Re[j], yj = yw[j];
#pragma unroll
              for (int r = 0; r < kRows; ++r) {
                if (on[r]) {
                  T* Rkj = R + (k0 + r * NT) * ld + j;
                  const T u = t0[r] * rj + t1[r] * yj;
                  const T nv = is_rem ? *Rkj + u : *Rkj - u;
                  *Rkj = nv;
                  now_nonfinite |= !isfinite(nv);
                }
              }
            }
          } else {
            for (int w = 0; w < nws; ++w) {
              unsigned bits = msup[w];
              while (bits) {
                const int j = (w << 5) + __ffs(bits) - 1;
                bits &= bits - 1;
                const T rj = Re[j], yj = yw[j];
#pragma unroll
                for (int r = 0; r < kRows; ++r) {
                  if (on[r]) {
                    T* Rkj = R + (k0 + r * NT) * ld + j;
                    const T u = t0[r] * rj + t1[r] * yj;
                    const T nv = is_rem ? *Rkj + u : *Rkj - u;
                    *Rkj = nv;
                    now_nonfinite |= !isfinite(nv);
                  }
                }
              }
            }
          }
        }
        const bool broke = team_any<NT>(now_nonfinite);
        dense = dense || broke;
      }
      team_sync<NT>();
    }
    return iters;
  }

  // Write lane b out: rows, slots (K4), the inverse where it lived in
  // shared memory, the counts and flags.
  __device__ __forceinline__ void store(const Args<T>& a, int b, int iters) {
    const size_t ob = static_cast<size_t>(b) * m;
    for (int i = tid; i < m; i += NT) {
      a.lam[ob + i] = lam[i];
      a.act[ob + i] = act[i];
      a.side[ob + i] = side[i];
    }
    if constexpr (kSlots)
      for (int k = tid; k < s; k += NT) a.slots[static_cast<size_t>(b) * s + k] = slot_row[k];
    const size_t ss = static_cast<size_t>(s) * s;
    if (a.inv_in_smem) copy_inv<T, true>(R, ld, a.inv + b * ss, s, tid, NT);
    if (tid == 0) {
      a.iters[b] = iters;
      a.done[b] = done;
      a.infeas[b] = infeas;
      if constexpr (kSlots) a.ovf[b] = ovf;
      if (a.pend0 != nullptr) {
        a.pend[b] = pend;
        a.pside[b] = pend_side;
      }
    }
    team_sync<NT>();
  }
};

// The loop of lane b: until it converges, is flagged infeasible, overflows
// its slots (K4) or reaches max_iter; with retry != 0, a lane flagged from
// its warm start is reset to a cold start and every lane not done runs up
// to max_iter more iterations (pallas_iu.py:509-523, pallas_ciu.py:446-462).
// K3's resumable entry (pend0 set) continues a lane from its full carried
// state for max_iter more iterations at most, as one call of the Pallas
// stepper (pallas_iu.py:393-451): no retry, a done lane untouched, infeas
// sticky.
template <typename T, bool kSlots, int NT>
__device__ __forceinline__ void lane(const Args<T>& a, int b, const T* GT, const T* GsT,
                                     unsigned char* base) {
  Lane<T, kSlots, NT> L(a, b, base);
  L.load(a, b);
  int iters = 0;
  for (int phase = 0; phase < (a.retry ? 2 : 1); ++phase) {
    // a ray found from a warm start is not trusted: restart cold
    if (phase == 1 && L.infeas) L.cold_reset();
    iters += L.iterate(a, GT, GsT, a.max_iter);
  }
  L.store(a, b, iters);
}

// The most threads of a block whose teams have NT threads each: the
// __launch_bounds__ of the kernels that run run_lanes().
__host__ __device__ constexpr int block_threads(int NT) {
  return NT == 32 ? 32 * kMaxLanesPerBlock : NT;
}

// The body of a persistent block (each kernel's __global__ entry calls it):
// G, and G_solve after it, staged once into shared memory (16-byte
// cp.async) as launch() chose, then each team takes lanes from the work
// counter until none is left and runs body(b, GT, GsT, base) on each, base
// its own shared memory.
template <typename T, int NT, typename Body>
__device__ __forceinline__ void for_each_lane(const Args<T>& a, Body&& body) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int next_lane;  // the wide team's lane, handed out by thread 0
  const T* GT = a.GT;
  const T* GsT = a.GsT;
  unsigned char* base = smem_raw;
  if (a.g_staged) {
    T* g = reinterpret_cast<T*>(smem_raw);
    const size_t mm = static_cast<size_t>(a.m) * a.m;
    const int nmat = a.g_staged;
    const bool vec = aligned16(a.GT) && aligned16(a.GsT) && (mm * sizeof(T)) % 16 == 0;
    if (vec) {
      const size_t nv = mm * sizeof(T) / 16;
      for (size_t v = threadIdx.x; v < nmat * nv; v += blockDim.x) {
        const char* src = v < nv ? reinterpret_cast<const char*>(a.GT) + 16 * v
                                 : reinterpret_cast<const char*>(a.GsT) + 16 * (v - nv);
        const unsigned dst =
            static_cast<unsigned>(__cvta_generic_to_shared(reinterpret_cast<char*>(g) + 16 * v));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
      }
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 0;\n" ::);
    } else {
      for (size_t e = threadIdx.x; e < nmat * mm; e += blockDim.x)
        g[e] = e < mm ? a.GT[e] : a.GsT[e - mm];
    }
    __syncthreads();
    GT = g;
    if (nmat == 2) GsT = g + mm;
    base += up16(nmat * mm * sizeof(T));
  }
  if constexpr (NT == 32) base += static_cast<size_t>(threadIdx.x >> 5) * a.lane_bytes;
  for (;;) {
    int b = 0;
    if constexpr (NT == 32) {
      if ((threadIdx.x & 31) == 0) b = atomicAdd(a.work, 1);
      b = __shfl_sync(kFull, b, 0);
    } else {
      __syncthreads();
      if (threadIdx.x == 0) next_lane = atomicAdd(a.work, 1);
      __syncthreads();
      b = next_lane;
    }
    if (b >= a.B) break;
    body(b, GT, GsT, base);
  }
}

// The GI bulk phase of every lane (K3's and K4's entries).
template <typename T, bool kSlots, int NT>
__device__ __forceinline__ void run_lanes(Args<T> a) {
  for_each_lane<T, NT>(a, [&](int b, const T* GT, const T* GsT, unsigned char* base) {
    lane<T, kSlots, NT>(a, b, GT, GsT, base);
  });
}

// Launch kernel(a, extra...) with teams of NT threads: lanes a block and
// the matrices staged as shared memory allows, one persistent block per SM
// at most as occupancy allows.
template <typename T, bool kSlots, int NT, typename... Extra>
cudaError_t launch_team(void (*kernel)(Args<T>, Extra...), Args<T> a, cudaStream_t stream,
                        Extra... extra) {
  const size_t per_lane = lane_bytes<T, kSlots>(a.m, a.s, a.inv_in_smem) + a.extra_bytes;
  const size_t mat_bytes = sizeof(T) * static_cast<size_t>(a.m) * a.m;
  int dev = 0, nsm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  // a small batch spreads over every SM, one lane per warp
  int want = 1;
  if (NT == 32) want = std::min(kMaxLanesPerBlock, std::max(1, (a.B + nsm - 1) / nsm));
  // stage G and G_solve where a lane fits beside them, else G alone, else
  // neither: the GI step gathers from both every iteration
  int lanes = 0;
  for (int nmat = 2; nmat >= 0 && lanes < 1; --nmat) {
    const size_t g_bytes = up16(nmat * mat_bytes);
    const int fit = g_bytes < kBlockSmem ? static_cast<int>((kBlockSmem - g_bytes) / per_lane) : 0;
    lanes = std::min(fit, want);
    a.g_staged = nmat;
  }
  if (lanes < 1) return cudaErrorInvalidValue;
  a.lane_bytes = static_cast<int>(per_lane);
  const size_t smem = up16(a.g_staged * mat_bytes) + lanes * per_lane;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int threads = NT == 32 ? 32 * lanes : NT;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int blocks = std::min((a.B + lanes - 1) / lanes, per_sm * nsm);
  e = cudaMemsetAsync(a.work, 0, sizeof(int), stream);
  if (e != cudaSuccess) return e;
  last_plan = Plan{NT, lanes, blocks, a.g_staged, a.inv_in_smem, static_cast<int>(smem)};
  kernel<<<blocks, threads, smem, stream>>>(a, extra...);
  return cudaGetLastError();
}

// Launch the lane loop: a warp per lane (``warp``, the kernel's
// instantiation at NT = 32) where the inverse fits in shared memory beside
// the lane's arrays and s <= 64, else a 128-thread team per lane (``wide``,
// at NT = kWide; with the inverse updated in place in the output above the
// budget).
template <typename T, bool kSlots>
cudaError_t launch(void (*warp)(Args<T>), void (*wide)(Args<T>), Args<T> a,
                   cudaStream_t stream) {
  a.inv_in_smem = lane_bytes<T, kSlots>(a.m, a.s, true) <= kInvLimit;
  if (a.inv_in_smem && a.s <= 64) return launch_team<T, kSlots, 32>(warp, a, stream);
  return launch_team<T, kSlots, kWide>(wide, a, stream);
}

}  // namespace gi
