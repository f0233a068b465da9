"""Runtime formatting of references/disturbances/parameters into theta.

Host-side analogs of the reference's input formatting
(src/utils.jl:78-261): tile/pad preview trajectories, condense reference
trajectories to setpoints, and assemble the parameter vector
theta = [x; r; d; u_prev; p] (reference src/explicit.jl:54-63).
"""

from __future__ import annotations

import numpy as np


def _pad_traj(mat: np.ndarray, Np: int) -> np.ndarray:
    """Truncate or hold-last-column pad a (n, T) trajectory to (n, Np)."""
    if mat.shape[1] >= Np:
        return mat[:, :Np]
    out = np.zeros((mat.shape[0], Np))
    out[:, : mat.shape[1]] = mat
    out[:, mat.shape[1] :] = mat[:, -1:]
    return out


def format_reference(mpc, r):
    """(reference src/utils.jl:78-134)"""
    if not mpc.settings.reference_tracking:
        return np.zeros(0)
    if r is None:
        r = np.zeros(mpc.model.ny)
    r = np.asarray(r, dtype=np.float64)
    if r.size == 0:
        return r.ravel()
    ny = mpc.model.ny
    if mpc.settings.reference_preview:
        if r.ndim == 1:
            if len(r) != ny:
                raise ValueError(f"Reference vector length ({len(r)}) must match number of outputs ({ny})")
            return condense_reference(mpc, np.tile(r, mpc.Np))
        if r.shape[0] != ny:
            raise ValueError(f"Reference matrix must have {ny} rows (number of outputs)")
        return condense_reference(mpc, _pad_traj(r, mpc.Np).T.ravel())
    if r.ndim == 1:
        if len(r) != ny:
            raise ValueError(f"Reference vector length ({len(r)}) must match number of outputs ({ny})")
        return r
    if r.shape[0] != ny:
        raise ValueError(f"Reference matrix must have {ny} rows (number of outputs)")
    return r[:, 0]


def condense_reference(mpc, r):
    """(reference src/utils.jl:140-147)"""
    if mpc.settings.reference_condensation:
        if mpc.traj2setpoint.size == 0:
            mpc.invalidate()
            mpc.ensure_setup()
        return mpc.traj2setpoint @ r
    return r


def format_disturbance(mpc, d):
    """(reference src/utils.jl:155-205); merges observer-estimated
    offset-free disturbances first."""
    d = get_control_disturbance(mpc, d)
    nd_base = mpc.model.nd
    if nd_base == 0:
        return np.zeros(0)
    if d is None:
        d = np.zeros(nd_base)
    d = np.asarray(d, dtype=np.float64)
    if d.size == 0:
        return d.ravel()
    if mpc.settings.disturbance_preview:
        if d.ndim == 1:
            if len(d) != nd_base:
                raise ValueError(
                    f"Disturbance vector length ({len(d)}) must match number of disturbances ({nd_base})"
                )
            return np.tile(d[:, None], (1, mpc.Np)).T.ravel()
        if d.shape[0] != nd_base:
            raise ValueError(f"Disturbance matrix must have {nd_base} rows (number of disturbances)")
        return _pad_traj(d, mpc.Np).T.ravel()
    if d.ndim == 1:
        if len(d) != nd_base:
            raise ValueError(
                f"Disturbance vector length ({len(d)}) must match number of disturbances ({nd_base})"
            )
        return d
    if d.shape[0] != nd_base:
        raise ValueError(f"Disturbance matrix must have {nd_base} rows (number of disturbances)")
    return d[:, 0]


def get_control_disturbance(mpc, d=None):
    """Combine measured and observer-estimated disturbance channels
    (reference src/observer.jl:203-222)."""
    from ..observer import OffsetFreeObserver

    observer = mpc.state_observer
    if not isinstance(observer, OffsetFreeObserver):
        return d
    d_est = observer.estimated_disturbance()
    if d is None:
        d_measured = np.zeros(observer.nd_measured)
        return np.concatenate([d_measured, d_est])
    d = np.asarray(d, dtype=np.float64)
    if d.ndim == 1 and len(d) == observer.nd_measured:
        return np.concatenate([d, d_est])
    if d.ndim == 2 and d.shape[0] == observer.nd_measured:
        if d_est.size == 0:
            return d
        return np.vstack([d, np.tile(d_est[:, None], (1, d.shape[1]))])
    if d.ndim == 2 and d.shape[0] == mpc.model.nd:
        return d
    if d.ndim == 1 and len(d) == mpc.model.nd:
        return d
    raise ValueError(
        f"Disturbance vector must have length {observer.nd_measured} or {mpc.model.nd}"
    )


def format_affine_parameters(mpc, p):
    """(reference src/utils.jl:225-261)"""
    from ..condense import get_affine_parameter_base_dim

    np_base = get_affine_parameter_base_dim(mpc)
    if not mpc.mpqp_issetup:
        np_total = np_base * mpc.Np if mpc.settings.parameter_preview else np_base
    else:
        np_total = mpc.np
    if np_total == 0:
        return np.zeros(0)
    if p is None:
        return np.zeros(np_total)
    p = np.asarray(p, dtype=np.float64)
    Np = mpc.Np
    if p.ndim == 1 and len(p) == np_base:
        return np.tile(p[:, None], (1, Np)).T.ravel() if mpc.settings.parameter_preview else p
    if p.ndim == 1 and len(p) == np_total:
        return p
    if p.ndim == 2:
        if p.shape[0] != np_base:
            raise ValueError(f"Generalized parameter matrix must have {np_base} rows")
        if not mpc.settings.parameter_preview:
            return p[:, 0]
        return _pad_traj(p, Np).T.ravel()
    raise ValueError("Generalized parameters must be a vector or matrix")


def form_parameter(mpc, x, r=None, d=None, uprev=None, p=None) -> np.ndarray:
    """Assemble theta = [x; r; d; u_prev; p] (reference src/explicit.jl:54-63)."""
    nx, nr, nd, nuprev, np_ = mpc.get_parameter_dims()
    x = np.asarray(x, dtype=np.float64).ravel()
    r_vec = format_reference(mpc, r)
    d_vec = format_disturbance(mpc, d)
    if len(d_vec) != nd:
        raise ValueError(f"Disturbance vector must have length {nd}")
    up = mpc.uprev[:nuprev] if uprev is None else np.asarray(uprev, dtype=np.float64).ravel()[:nuprev]
    p_vec = format_affine_parameters(mpc, p)
    return np.concatenate([x, r_vec, d_vec, up, p_vec])


# -- parameter-label helpers (reference src/utils.jl:301-325) ---------------

def prettify_parameter_label(label: str) -> str:
    """Render a theta-entry name for plot axes: trailing 'p' (previous
    control) becomes a '^-' superscript, trailing 'r' (reference) '^r',
    and previewed references 'yr_k' become 'y^r_k'."""
    import re

    s = str(label)
    if re.search(r"r_\d+$", s):
        base, step = s.rsplit("_", 1)
        return f"{base[:-1]}^r_{step}"
    if s.endswith("p"):
        return s[:-1] + "^-"
    if s.endswith("r"):
        return s[:-1] + "^r"
    return s


def label2id(mpc, label: str):
    """(index into theta, prettified label) for a named parameter entry;
    index is None when the label is unknown."""
    names = mpc.get_parameter_names()
    try:
        idx = names.index(str(label))
    except ValueError:
        return None, str(label)
    return idx, prettify_parameter_label(str(label))


def make_subscript(label: str) -> str:
    """Insert an underscore before the first digit: 'x1' -> 'x_1'."""
    for i, ch in enumerate(str(label)):
        if ch.isdigit():
            return f"{label[:i]}_{label[i:]}"
    return str(label)
