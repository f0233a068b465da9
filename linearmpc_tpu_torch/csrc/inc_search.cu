// K3's branch-and-bound entry: the whole float32 incremental node-frontier
// search of every lane in one launch, a warp a lane.
//
// Replaces the host loop of rounds over K3's resumable entry (lmpc_iu_step
// in iu.cu) and torch management, the port of
// linearmpc_tpu/ops/bnb_frontier.py::solve_bnb_frontier_inc, whose body
// the JAX package runs as one jax.lax.while_loop on the device around the
// Pallas stepper (make_iu_stepper, pallas_iu.py:393-451, over
// _iu_iteration_kernel, pallas_iu.py:107). Every quantity of a round is
// per lane (the node stack, the incumbent, the pops), and a lane that
// finishes stays frozen, so a warp that alternates {at most K GI
// iterations; the management} until its lane can neither solve nor pop
// follows the lane's sequence of the lockstep rounds
// (IncFrontier.round, ops/bnb_frontier.py), the kernel's plain version.
// The rounds sum as this kernel does (row sums in index order, a warp's
// sums as bnb_frontier.lane_sum), so the two agree bit for bit.
//
// Per round of a lane: gi::Lane::iterate for at most K iterations (K3's GI
// loop, unchanged), then, in the order of IncFrontier.round: the node's
// verdict (converged; capped at node_cap; a dual ray, retried once from a
// cold start, pruned on the retry); U = U0 - HinvET lam and fval =
// U'HU / 2 + f_t'U; the mid-solve dual bound gval and its prune; the most
// fractional branchable row (first index on ties, -BIG where not
// branchable); the root snapshot; the incumbent; the far child pushed, the
// near child continued in place with its row clamped; the stacked nodes
// whose bound reaches the incumbent discarded; and a backtrack pop, which
// restarts from the root relaxation's snapshot.
//
// Design. The inverse R (m x m, padded rows), the lane's GI arrays and the
// node state stay in shared memory for the whole search: R leaves it only
// to save the root snapshot (once a lane, into a (B, m, m) global buffer),
// to be restored from that snapshot at a backtrack pop, and is set to the
// identity on a ray retry. The node stack holds cap x m bits of fixed rows
// and of their sides and cap bounds (1.6 KB at m = 60, cap = 82); the
// current node's fixed rows and sides and the root working set are bit
// masks too. G and G_solve are staged once a block (cp.async); H and
// HinvET are read through L2. Reductions are the GI loop's: first-hit
// arg-reductions by shuffles, sums by a butterfly (every thread ends with
// the same value).
//
// What bounds it: the latency of one lane's chain of GI iterations and
// management steps (a lane's search is hundreds of iterations, each a
// chain of short sums), not bytes or operations: the batch ends with its
// slowest lane.
//
// Precision and sentinels: float32 throughout, built with -fmad=false like
// every kernel here; big = 3e38 inside the GI loop (as lmpc_iu_step takes
// it), the frontier's BIG = 1e30 and BIN_TOL = 1e-6 in the management.

#include "gi_common.cuh"

namespace {

constexpr int kTeam = 32;  // a warp a lane

template <typename T>
struct SearchArgs {
  int n, cap, node_cap, node_limit;
  const T* HinvET;  // (n, m) row-major
  const T* H;       // (n, n)
  const T* U0;      // (B, n): u_off + Uth_off theta
  const T* f_t;     // (B, n): f + f_theta theta
  const uint8_t* up_finite;   // (m,)
  const uint8_t* lo_finite;   // (m,)
  const uint8_t* branchable;  // (m,): binary, mutable, a finite bound
  T BIG, bin_tol;
  T* root_R;  // (B, m, m) scratch: each lane's root snapshot of R
  // outputs
  uint8_t* inc_found;   // (B,)
  T* inc_fval;          // (B,)
  uint8_t* inc_active;  // (B, m)
  uint8_t* inc_side;    // (B, m)
  int32_t* nodes;       // (B,)
  int32_t* iters;       // (B,)
  uint8_t* exhausted;   // (B,)
  int32_t* rounds;      // (B,): management steps the lane ran
  int32_t* retries;     // (B,): cold ray retries
};

// Shared-memory bytes of a lane's search state beyond its GI arrays: the
// root multipliers, U and the stack bounds; then the root working set and
// sides, the current node's fixed rows and sides, and the stack's fixed
// rows and sides, one bit a row.
template <typename T>
__host__ __device__ __forceinline__ size_t search_bytes(int m, int n, int cap) {
  const size_t nwm = (m + 31) / 32;
  return gi::up16(sizeof(T) * (m + n + cap)) +
         gi::up16(4 * nwm * (4 + 2 * static_cast<size_t>(cap)));
}

__device__ __forceinline__ bool bit(const unsigned* w, int i) {
  return (w[i >> 5] >> (i & 31)) & 1u;
}

// The warp's sum of v by a butterfly: every thread ends with the same value
// (each step adds two partial sums, in either order the same float).
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(gi::kFull, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ void search_lane(const gi::Args<T>& a, const SearchArgs<T>& q, int b,
                                            const T* GT, const T* GsT, unsigned char* base) {
  constexpr int NT = kTeam;
  gi::Lane<T, false, NT> L(a, b, base);
  const int m = a.m, n = q.n, cap = q.cap, nwm = L.nwm, tid = L.tid;
  const size_t ob = static_cast<size_t>(b) * m, on = static_cast<size_t>(b) * n;
  const T* du_t = a.du_t + ob;
  const T* dl_t = a.dl_t + ob;
  const T BIG = q.BIG;
  T* root_R = q.root_R + static_cast<size_t>(b) * m * m;

  unsigned char* xb = base + gi::lane_bytes<T, false>(m, m, true);
  T* root_lam = reinterpret_cast<T*>(xb);
  T* Uv = root_lam + m;
  T* sbound = Uv + n;
  unsigned* root_act = reinterpret_cast<unsigned*>(xb + gi::up16(sizeof(T) * (m + n + cap)));
  unsigned* root_side = root_act + nwm;
  unsigned* cur_fixed = root_side + nwm;
  unsigned* cur_fside = cur_fixed + nwm;
  unsigned* sfixed = cur_fside + nwm;  // (cap, nwm)
  unsigned* sside = sfixed + static_cast<size_t>(cap) * nwm;

  // the root node: nothing fixed, a cold GI state (which is also the root
  // snapshot until the root converges)
  for (int i = tid; i < m; i += NT) {
    L.du[i] = du_t[i];
    L.dl[i] = dl_t[i];
    L.eq[i] = a.eq[i] != 0;
    L.immut[i] = a.immut[i] != 0;
    L.lam[i] = T(0);
    L.act[i] = 0;
    L.side[i] = 1;
    root_lam[i] = T(0);
    q.inc_active[ob + i] = 0;
    q.inc_side[ob + i] = 0;
  }
  for (int w = tid; w < nwm; w += NT) {
    root_act[w] = 0u;
    root_side[w] = gi::all_bits(w, m);
    cur_fixed[w] = 0u;
    cur_fside[w] = 0u;
  }
  gi::set_identity(L.R, L.ld, m, tid, NT);
  gi::team_sync<NT>();

  int top = 0, node_iter = 0, nodes = 1, iters = 0, rounds = 0, retries = 0;
  bool active = true, root_saved = false, ray_retry = false, exhausted = false;
  bool inc_found = false;
  T inc_fval = BIG;

  while (active) {
    // ---- at most K GI iterations of the current node
    const int steps = L.iterate(a, GT, GsT, a.max_iter);
    iters += steps;
    node_iter += steps;
    ++rounds;

    // ---- the node's verdict
    const bool done = L.done != 0, infeas = L.infeas != 0;
    const bool conv = done && !infeas;
    const bool nfail_exh = !done && node_iter >= q.node_cap;
    // a ray reached from warm carried state is retried once from a cold
    // start; only a ray found on the retry prunes the node
    const bool ray = done && infeas;
    const bool retry = ray && !ray_retry;
    const bool nfail = (ray && ray_retry) || nfail_exh;

    // ---- objective, dual bound, most fractional row: where read
    T fval = T(0);
    bool pruned_conv = false, prune_mid = false, integral = false, near_up = false;
    int jb = 0;
    if (conv || (!done && inc_found)) {
      L.ballots(m, L.mb, [&](int i) { return L.lam[i] != T(0); });
      gi::team_sync<NT>();
      gi::matvec_nz<T, NT>(L.c, GT, 1, m, L.lam, L.mb, nwm, m, tid);         // G lam
      gi::matvec_nz<T, NT>(Uv, q.HinvET, m, 1, L.lam, L.mb, nwm, n, tid);    // HinvET lam
      for (int k = tid; k < n; k += NT) Uv[k] = q.U0[on + k] - Uv[k];
      gi::team_sync<NT>();
      T p_hu = T(0), p_f = T(0), p_g = T(0);
      for (int k = tid; k < n; k += NT) {
        const T* hk = q.H + static_cast<size_t>(k) * n;
        T acc = hk[0] * Uv[0];
        for (int l = 1; l < n; ++l) acc = acc + hk[l] * Uv[l];
        p_hu = p_hu + acc * Uv[k];
        p_f = p_f + q.f_t[on + k] * Uv[k];
      }
      for (int i = tid; i < m; i += NT)
        if (L.act[i]) p_g = p_g + L.lam[i] * ((L.side[i] ? L.du[i] : L.dl[i]) + L.c[i]);
      fval = T(0.5) * warp_sum(p_hu) + warp_sum(p_f);
      // every GI iterate is dual feasible: its dual value bounds the node
      const T gval = fval - warp_sum(p_g);
      pruned_conv = conv && inc_found && fval >= inc_fval;
      prune_mid = !done && inc_found && gval >= inc_fval + T(1e-4) * (T(1) + fabs(inc_fval));
      if (conv) {
        T bv = -gi::inf<T>();
        int bi = INT_MAX;
        for (int i = tid; i < m; i += NT) {
          const T ci = L.c[i];
          const T su = q.up_finite[i] ? du_t[i] + ci : BIG;
          const T sl = q.lo_finite[i] ? -dl_t[i] - ci : BIG;
          const T fr = (q.branchable[i] && !bit(cur_fixed, i)) ? gi::nan_min(su, sl) : -BIG;
          gi::scan(false, fr, i, bv, bi);
        }
        gi::team_arg<NT>(false, bv, bi, L.red_v, L.red_i);
        jb = bi;
        integral = bv <= q.bin_tol;
        const T cj = L.c[jb];
        const T su = q.up_finite[jb] ? du_t[jb] + cj : BIG;
        const T sl = q.lo_finite[jb] ? -dl_t[jb] - cj : BIG;
        near_up = su <= sl;
      }
    }

    // ---- the root relaxation's state at its convergence: a warm start
    //      valid for every node of the lane (R depends on the working set
    //      only, not on the bounds)
    if (conv && !root_saved) {
      for (int i = tid; i < m; i += NT) root_lam[i] = L.lam[i];
      L.ballots(m, root_act, [&](int i) { return L.act[i] != 0; });
      L.ballots(m, root_side, [&](int i) { return L.side[i] != 0; });
      gi::copy_inv<T, true>(L.R, L.ld, root_R, m, tid, NT);
      root_saved = true;
      gi::team_sync<NT>();
    }

    // ---- incumbent: the working set pins every fixed binary row at its
    //      branched bound and side for the float64 polish
    const bool better = conv && !pruned_conv && integral && fval < inc_fval;
    if (better) {
      inc_fval = fval;
      inc_found = true;
      for (int i = tid; i < m; i += NT) {
        const bool f = bit(cur_fixed, i);
        q.inc_active[ob + i] = L.act[i] || f;
        q.inc_side[ob + i] = f ? bit(cur_fside, i) : (L.side[i] != 0);
      }
    }

    // ---- branch on jb: push the far child, continue the near child in
    //      place (only the branched row clamps)
    const bool branch = conv && !pruned_conv && !integral;
    if (branch) {
      const int jw = jb >> 5;
      const unsigned jbit = 1u << (jb & 31);
      const bool far_viable = near_up ? q.lo_finite[jb] != 0 : q.up_finite[jb] != 0;
      if (far_viable && top < cap) {
        for (int w = tid; w < nwm; w += NT) {
          const unsigned fs = cur_fside[w];
          sfixed[top * nwm + w] = cur_fixed[w] | (w == jw ? jbit : 0u);
          sside[top * nwm + w] = w == jw ? (near_up ? fs & ~jbit : fs | jbit) : fs;
        }
        if (tid == 0) sbound[top] = fval;
        ++top;
      }
      gi::team_sync<NT>();
      if (tid == 0) {
        cur_fixed[jw] |= jbit;
        cur_fside[jw] = near_up ? (cur_fside[jw] | jbit) : (cur_fside[jw] & ~jbit);
        const T d_b = near_up ? du_t[jb] : dl_t[jb];
        L.du[jb] = d_b;
        L.dl[jb] = d_b;
        L.eq[jb] = 1;
      }
      ++nodes;
      L.done = 0;  // the near child resumes the parent's solver state
      gi::team_sync<NT>();
    }

    const bool finished = (conv && (pruned_conv || integral)) || nfail || prune_mid;
    active = !finished;
    exhausted = exhausted || nfail_exh;
    if (branch || finished || retry) node_iter = 0;
    ray_retry = (branch || finished) ? false : (ray_retry || retry);
    retries += retry;

    // ---- discard the stacked nodes whose parent bound reaches the
    //      incumbent, then pop for an idle lane (restart from the root
    //      snapshot; a cold state before the root converged)
    while (top > 0 && inc_found && sbound[top - 1] >= inc_fval) --top;
    if (!active && top > 0 && nodes < q.node_limit) {
      --top;
      ++nodes;
      active = true;
      const unsigned* pf = sfixed + top * nwm;
      const unsigned* ps = sside + top * nwm;
      for (int i = tid; i < m; i += NT) {
        const bool f = bit(pf, i);
        const T d_f = bit(ps, i) ? du_t[i] : dl_t[i];
        L.du[i] = f ? d_f : du_t[i];
        L.dl[i] = f ? d_f : dl_t[i];
        L.eq[i] = (a.eq[i] != 0) || f;
        L.lam[i] = root_lam[i];
        L.act[i] = bit(root_act, i);
        L.side[i] = bit(root_side, i);
      }
      gi::team_sync<NT>();
      for (int w = tid; w < nwm; w += NT) {
        cur_fixed[w] = pf[w];
        cur_fside[w] = ps[w];
      }
      int nonfinite = 0;
      if (root_saved) {
        nonfinite = gi::copy_inv<T, false>(L.R, L.ld, root_R, m, tid, NT);
      } else {
        gi::set_identity(L.R, L.ld, m, tid, NT);
      }
      L.dense = gi::team_any<NT>(nonfinite);
      L.pend = -1;
      L.infeas = 0;
      L.done = 0;
      gi::team_sync<NT>();
    } else if (!active) {
      L.done = 1;  // a lane that can neither solve nor pop: frozen
    }
    // ray retry: the same node from a genuinely cold state (not the root
    // snapshot, whose R may hold the drift behind the ray)
    if (retry) L.cold_reset();
  }

  if (tid == 0) {
    q.inc_found[b] = inc_found;
    q.inc_fval[b] = inc_fval;
    q.nodes[b] = nodes;
    q.iters[b] = iters;
    q.exhausted[b] = exhausted;
    q.rounds[b] = rounds;
    q.retries[b] = retries;
  }
  gi::team_sync<NT>();  // before the warp's next lane reuses the memory
}

template <typename T>
__global__ void __launch_bounds__(gi::block_threads(kTeam), 1)
    search_kernel(gi::Args<T> a, SearchArgs<T> q) {
  gi::for_each_lane<T, kTeam>(a, [&](int b, const T* GT, const T* GsT, unsigned char* base) {
    search_lane<T>(a, q, b, GT, GsT, base);
  });
}

}  // namespace

// The search of B lanes in float32. GT and GsT are G and G_solve transposed
// (m, m), du/dl (B, m) the lanes' bounds, is_eq/immut/up_finite/lo_finite/
// branchable (m,) one byte each, HinvET (n, m), H (n, n), U0 and f_t
// (B, n); root_R (B, m, m) and work (one int32) are scratch. Outputs:
// inc_found, inc_fval, inc_active/inc_side (B, m), nodes, iters,
// exhausted, rounds and retries (B,). K GI iterations a round at most,
// cap stacked nodes a lane, node_cap iterations a node, node_limit nodes a
// lane. Returns the cudaError_t of the launch.
extern "C" int lmpc_iu_search(int m, int n, int B, const void* GT, const void* GsT,
                              const void* du, const void* dl, const void* is_eq,
                              const void* immut, const void* up_finite, const void* lo_finite,
                              const void* branchable, const void* HinvET, const void* H,
                              const void* U0, const void* f_t, void* root_R, void* inc_found,
                              void* inc_fval, void* inc_active, void* inc_side, void* nodes,
                              void* iters, void* exhausted, void* rounds, void* retries,
                              void* work, int K, int cap, int node_cap, int node_limit,
                              double ptol, double stol, double gtol, double big, double BIG,
                              double bin_tol, void* stream) {
  using T = float;
  if (m < 1 || n < 1 || B < 1 || K < 1 || cap < 1) return cudaErrorInvalidValue;
  // the inverse lives in shared memory for the whole search
  if (gi::lane_bytes<T, false>(m, m, true) > gi::kInvLimit) return cudaErrorInvalidValue;
  gi::Args<T> a{};
  a.m = m;
  a.s = m;
  a.B = B;
  a.GT = static_cast<const T*>(GT);
  a.GsT = static_cast<const T*>(GsT);
  a.du_t = static_cast<const T*>(du);
  a.dl_t = static_cast<const T*>(dl);
  a.eq = static_cast<const uint8_t*>(is_eq);
  a.immut = static_cast<const uint8_t*>(immut);
  a.work = static_cast<int*>(work);
  a.max_iter = K;
  a.ptol = static_cast<T>(ptol);
  a.stol = static_cast<T>(stol);
  a.gtol = static_cast<T>(gtol);
  a.big = static_cast<T>(big);
  a.inv_in_smem = 1;
  a.extra_bytes = static_cast<int>(search_bytes<T>(m, n, cap));
  SearchArgs<T> q{};
  q.n = n;
  q.cap = cap;
  q.node_cap = node_cap;
  q.node_limit = node_limit;
  q.HinvET = static_cast<const T*>(HinvET);
  q.H = static_cast<const T*>(H);
  q.U0 = static_cast<const T*>(U0);
  q.f_t = static_cast<const T*>(f_t);
  q.up_finite = static_cast<const uint8_t*>(up_finite);
  q.lo_finite = static_cast<const uint8_t*>(lo_finite);
  q.branchable = static_cast<const uint8_t*>(branchable);
  q.BIG = static_cast<T>(BIG);
  q.bin_tol = static_cast<T>(bin_tol);
  q.root_R = static_cast<T*>(root_R);
  q.inc_found = static_cast<uint8_t*>(inc_found);
  q.inc_fval = static_cast<T*>(inc_fval);
  q.inc_active = static_cast<uint8_t*>(inc_active);
  q.inc_side = static_cast<uint8_t*>(inc_side);
  q.nodes = static_cast<int32_t*>(nodes);
  q.iters = static_cast<int32_t*>(iters);
  q.exhausted = static_cast<uint8_t*>(exhausted);
  q.rounds = static_cast<int32_t*>(rounds);
  q.retries = static_cast<int32_t*>(retries);
  return gi::launch_team<T, false, kTeam>(search_kernel<T>, a, static_cast<cudaStream_t>(stream),
                                          q);
}

// The launch plan of the last search launch on this host thread, as iu.cu's
// lmpc_iu_plan: team threads, lanes a block, blocks, matrices staged,
// inverse in shared memory, shared-memory bytes a block (six ints into out).
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
