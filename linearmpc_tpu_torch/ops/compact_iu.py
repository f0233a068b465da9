"""Compact working-set GI iteration for large m: K4's plain version.

Port of ``linearmpc_tpu/ops/compact_iu.py``. Each lane carries a
fixed-capacity inverse over ``s`` working-set SLOTS instead of the full
(m, m) R of ``ops/iu.py``:

    Rw = inv(M_w),  M_w[k, l] = Gs[slots[k], slots[l]]  (occupied k, l)

with identity rows on free slots, and the slot assignment as an int map
``slots`` (B, s): the row a slot holds, -1 for a free slot (the Pallas
kernel carries the same assignment as a one-hot (s*m) matrix SEL;
``ops/ciu.py`` converts between the two). Memory and per-iteration work
drop from O(m^2) to O(s^2 + m) per lane.

The iteration is the GI scheme of ``ops/iu.py`` (shared ``gi_step``,
``gi_update``, ``woodbury``) with every working-set operation in slot
space, and follows ``pallas_ciu.py::_ciu_iteration_kernel``: an add takes
the first free slot, a removal frees the slot that held the row, the
dual blocker is the first ROW (not slot) with the smallest step, and a
full add with every slot occupied raises the lane's ``ovf`` flag and ends
it. As the XLA loop does (``compact_iu.py:106``), a lane whose entry
working set does not fit the slots starts done with ``ovf`` set.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .bulk import ordered_matvec
from .dual_active_set import _masked_inverse
from .iu import gi_step, gi_update, ordered_dot, run_lanes, sentinels, take, woodbury


class CompactCarry(NamedTuple):
    Rw: torch.Tensor     # (B, s, s) compact working-set inverse
    slots: torch.Tensor  # (B, s) int64 row held by each slot, -1 for a free slot


class CIUState(NamedTuple):
    lam: torch.Tensor
    act: torch.Tensor
    side: torch.Tensor
    pend: torch.Tensor
    pend_side: torch.Tensor
    iters: torch.Tensor
    done: torch.Tensor
    infeas: torch.Tensor
    ovf: torch.Tensor     # (B,) bool working set outgrew the slots
    slots: torch.Tensor
    Rw: torch.Tensor


def init_compact(Gs, act0, s_max: int) -> tuple[CompactCarry, torch.Tensor]:
    """Slot assignment and compact inverse of a batch of entry working sets
    (``compact_iu.py:49-66``): the active rows fill the first slots in row
    order and Rw is the masked inverse of their Gram block. Rows beyond
    ``s_max`` are dropped; the second return is the per-lane overflow."""
    act0 = act0.to(device=Gs.device, dtype=torch.bool)
    order = torch.argsort((~act0).to(torch.int8), dim=1, stable=True)
    sl = order[:, :s_max]
    occ = act0.gather(1, sl)
    Mw = Gs[sl[:, :, None], sl[:, None, :]]
    occf = occ.to(Gs.dtype)
    Mw = Mw * occf[:, :, None] * occf[:, None, :] + torch.diag_embed(1.0 - occf)
    return CompactCarry(_masked_inverse(Mw), torch.where(occ, sl, -1)), act0.sum(1) > s_max


def _cold_reset(st: dict, flag):
    """Reset flagged lanes to a cold start: empty working set, all slots
    free, identity inverse (``pallas_ciu.py:446-458``)."""
    f = flag[:, None]
    st["lam"] = torch.where(f, 0.0, st["lam"])
    st["act"] = st["act"] & ~f
    st["side"] = st["side"] | f
    st["pend"] = torch.where(flag, -1, st["pend"])
    st["done"] = st["done"] & ~flag
    st["infeas"] = st["infeas"] & ~flag
    st["slots"] = torch.where(f, -1, st["slots"])
    eye = torch.eye(st["Rw"].shape[1], dtype=st["Rw"].dtype, device=flag.device)
    st["Rw"] = torch.where(flag[:, None, None], eye, st["Rw"])


def iterate_ciu(G, Gs, du_t, dl_t, eq, immut, lam0, act0, side0, slots0, Rw0, *,
                max_iter: int, primal_tol: float, sign_tol: float,
                retry_infeas: bool = False) -> CIUState:
    """The batched compact GI iteration in the dtype of ``du_t`` from the
    entry state and slot carry (``slots0`` (B, s), ``Rw0`` (B, s, s)); each
    lane runs until it converges, is flagged infeasible, overflows its
    slots, or has run ``max_iter`` iterations."""
    B, m = du_t.shape
    s = slots0.shape[1]
    dtype, dev = du_t.dtype, du_t.device
    big, gtol = sentinels(dtype)
    G, Gs = G.to(dev, dtype), Gs.to(dev, dtype)
    GsT = Gs.T.contiguous()
    immut = immut.to(dev)
    sidx = torch.arange(s, device=dev)
    act0 = act0.to(dev, torch.bool)
    ovf0 = act0.sum(1) > s
    st = dict(
        lam=torch.where(act0, lam0.to(dev, dtype), 0.0), act=act0.clone(),
        side=side0.to(dev, torch.bool).clone(),
        pend=torch.full((B,), -1, dtype=torch.int64, device=dev),
        pend_side=torch.ones(B, dtype=torch.bool, device=dev),
        iters=torch.zeros(B, dtype=torch.int32, device=dev),
        done=ovf0.clone(), infeas=torch.zeros(B, dtype=torch.bool, device=dev),
        ovf=ovf0.clone(), slots=slots0.to(dev, torch.int64).clone(),
        Rw=Rw0.to(dev, dtype).clone(), du=du_t, dl=dl_t, eq=eq.to(dev).expand(B, m))

    def step(c):
        slots, Rw = c["slots"], c["Rw"]
        occ = slots >= 0
        sl = slots.clamp_min(0)
        dump = torch.where(occ, slots, m)  # free slots scatter to a dropped column

        def solve(x, dot_with=None):
            xw = torch.where(occ, x.gather(1, sl), 0.0)
            yw = ordered_matvec(Rw, xw)
            y = torch.zeros((x.shape[0], m + 1), dtype=dtype, device=dev)
            y = y.scatter(1, dump, yw)[:, :m]
            if dot_with is None:
                return y, None
            return y, ordered_dot(torch.where(occ, dot_with.gather(1, sl), 0.0), yw)

        d = gi_step(G, GsT, c["du"], c["dl"], c["eq"], immut, c["lam"], c["act"],
                    c["side"], c["pend"], c["pend_side"], ptol=primal_tol,
                    stol=sign_tol, gtol=gtol, big=big, solve=solve)
        no_step = d["t_step"] >= big
        infeas_now = d["live"] & no_step
        full = d["full_add"] & occ.all(1)  # a full add with no free slot
        ovf_now = d["live"] & ~no_step & full
        take_step = d["live"] & ~no_step & ~full
        lam, act, side, pend, pend_side, is_rem, ch = gi_update(
            d, c["lam"], c["act"], c["side"], c["pend"], c["pend_side"], take_step)

        # the changed row's slot: removal frees the slot holding it, an add
        # takes the first free slot
        hold = slots == ch[:, None]
        rem_slot = torch.where(hold.any(1), hold.to(torch.int8).argmax(1), -1)
        free_slot = torch.where((~occ).any(1), (~occ).to(torch.int8).argmax(1), -1)
        slot_ch = torch.where(is_rem, rem_slot, free_slot)
        eff = (d["hv"] | take_step) & (slot_ch >= 0)
        sc = slot_ch.clamp_min(0)
        at_sc = sidx == sc[:, None]
        slots_n = torch.where(eff[:, None] & at_sc,
                              torch.where(is_rem, -1, ch)[:, None], slots)
        # rank-2 Woodbury update of Rw at that slot, with the changed row's
        # Gram column gathered through the updated assignment
        Gch = GsT[ch]
        vcol = torch.where((slots_n >= 0) & ~at_sc, Gch.gather(1, slots_n.clamp_min(0)), 0.0)
        Rw = woodbury(Rw, sc, vcol, take(Gch, ch), is_rem, eff)
        return dict(lam=lam, act=act, side=side, pend=pend, pend_side=pend_side,
                    done=(~d["hv"] & d["conv"]) | infeas_now | ovf_now,
                    infeas=c["infeas"] | infeas_now, ovf=c["ovf"] | ovf_now,
                    slots=slots_n, Rw=Rw)

    st = run_lanes(step, st, max_iter, _cold_reset if retry_infeas else None)
    return CIUState(*(st[k] for k in CIUState._fields))
