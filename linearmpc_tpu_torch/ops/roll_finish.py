"""The gather and the merge of the small-m warm step's float64 finish.

``SolverEngine.fused_rollout_solve`` takes the first K lanes, in lane
order, that fail the step's status rule, continues them in float64
(``continue_from_state``: K1's float64 instantiation; then K2) and writes
the results back into only the lanes that failed. ``gather`` places them in K slots (a slot beyond the
failing lanes holds lane 0 and is not taken) with what the continuation
starts from, and ``merge`` writes its results in place. On CUDA tensors
each is one launch of ``csrc/roll_finish.cu``, the gather after a
``torch.cumsum`` of the passing lanes that gives each failing lane its
slot; on CPU tensors their plain versions run, the same copies as
indexing, equal bit for bit. Neither reads anything back to the host.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib

# kernel launches (the count a run reads to show the step went through them),
# and of them the merge's
LAUNCHES = 0
MERGE_LAUNCHES = 0

_GATHER_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 15
_MERGE_ARGTYPES = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 15 + [ctypes.c_double, ctypes.c_void_p]


def gather_plain(ok, K, th, lam, act, side, iters):
    failing = torch.nonzero(~ok).squeeze(1)[:K]
    idx = torch.zeros(K, dtype=torch.int64, device=ok.device)
    idx[: len(failing)] = failing
    take = torch.arange(K, device=ok.device) < len(failing)
    return idx, take, th[idx], lam[idx].to(torch.float64), act[idx], side[idx], iters[idx]


def merge_plain(idx, take, U_f, lam_f, act_f, side_f, it_f, done_f, bad_f,
                U, lam, act, side, iters, status, *, tol):
    lanes = idx[take]  # a spare slot may repeat a taken slot's lane 0
    for base, upd in ((U, U_f), (lam, lam_f), (act, act_f), (side, side_f), (iters, it_f)):
        base[lanes] = upd[take]
    one = torch.ones_like(it_f)
    status[lanes] = torch.where(done_f & (bad_f <= tol), one, -one)[take].to(status.dtype)


def _cuda_inputs(tensors, dtypes, dev):
    for t, dtype in zip(tensors, dtypes):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"roll_finish inputs must be contiguous on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"roll_finish: expected {dtype}, got {t.dtype}")


_B, _I32, _I64, _F32, _F64 = torch.bool, torch.int32, torch.int64, torch.float32, torch.float64


def gather(ok, K: int, th, lam, act, side, iters):
    """(idx, take, th_k, lam_k, act_k, side_k, iters_k) of K slots: the
    first K lanes, in lane order, where ``ok`` (B,) is false, then lane 0
    (``take`` false) in the slots beyond them; ``th`` (B, n_theta) float64,
    K1's float32 ``lam`` and its ``act``, ``side`` (B, m) and ``iters``
    (B,) int32 of each slot's lane, ``lam_k`` in float64. 1 <= K <= B."""
    global LAUNCHES
    if ok.device.type == "cpu":
        return gather_plain(ok, K, th, lam, act, side, iters)
    dev = ok.device
    cum_ok = torch.cumsum(ok, 0, dtype=torch.int32)
    _cuda_inputs((ok, cum_ok, th, lam, act, side, iters), (_B, _I32, _F64, _F32, _B, _B, _I32),
                 dev)
    (B, m), nth = lam.shape, th.shape[1]
    if not 1 <= K <= B:
        raise ValueError(f"roll_finish gather takes 1 <= K <= B, got K={K}, B={B}")
    idx = torch.empty(K, dtype=torch.int64, device=dev)
    take = torch.empty(K, dtype=torch.bool, device=dev)
    th_k = torch.empty((K, nth), dtype=torch.float64, device=dev)
    lam_k = torch.empty((K, m), dtype=torch.float64, device=dev)
    act_k = torch.empty((K, m), dtype=torch.bool, device=dev)
    side_k = torch.empty((K, m), dtype=torch.bool, device=dev)
    iters_k = torch.empty(K, dtype=torch.int32, device=dev)
    outs = (idx, take, th_k, lam_k, act_k, side_k, iters_k)
    fn = cuda_lib.function("roll_finish", "lmpc_roll_gather", _GATHER_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(B, K, m, nth, *(t.data_ptr() for t in (ok, cum_ok, th, lam, act, side, iters)),
                 *(t.data_ptr() for t in outs), cuda_lib.stream(dev))
    cuda_lib.check(err, "roll_finish gather launch")
    LAUNCHES += 1
    return outs


def merge(idx, take, U_f, lam_f, act_f, side_f, it_f, done_f, bad_f,
          U, lam, act, side, iters, status, *, tol: float):
    """Write the finish's results into the lanes of the slots ``take``, in
    place: ``U`` (B, n) and ``lam`` (B, m) float64 from K2's ``U_f`` and
    ``lam_f``, ``act``/``side`` from the float64 K1's ``act_f``/``side_f``,
    ``iters`` from its ``it_f`` (counted from the step's), and ``status`` 1
    where the lane is
    ``done_f`` with K2's residual ``bad_f`` within ``tol``, else -1. The
    other lanes keep every value."""
    global LAUNCHES, MERGE_LAUNCHES
    args = (idx, take, U_f, lam_f, act_f, side_f, it_f, done_f, bad_f,
            U, lam, act, side, iters, status)
    if idx.device.type == "cpu":
        merge_plain(*args, tol=tol)
        return
    dev = idx.device
    _cuda_inputs(args, (_I64, _B, _F64, _F64, _B, _B, _I32, _B, _F64,
                        _F64, _F64, _B, _B, _I32, _I32), dev)
    K = idx.shape[0]
    if K == 0:
        return
    fn = cuda_lib.function("roll_finish", "lmpc_roll_merge", _MERGE_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(K, lam.shape[1], U.shape[1], *(t.data_ptr() for t in args), float(tol),
                 cuda_lib.stream(dev))
    cuda_lib.check(err, "roll_finish merge launch")
    LAUNCHES += 1
    MERGE_LAUNCHES += 1
