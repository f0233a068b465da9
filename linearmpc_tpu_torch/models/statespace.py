"""Bridge from scipy.signal / python-control state-space objects.

Port of ``linearmpc_tpu/models/statespace.py``, carried over unchanged.

Analog of the reference's ControlSystemsBase weak-dependency extension
(ext/ControlSystemsExt.jl:1-22): build a ``Model`` from an LTI system
object, discretizing continuous systems with ZOH and splitting trailing
inputs into disturbance channels.
"""

from __future__ import annotations

import numpy as np

from .model import Model, make_model, model_from_continuous


def model_from_statespace(sys, *, Ts: float | None = None, nd: int = 0) -> Model:
    """Build a model from a state-space-like object.

    Accepts anything exposing A/B/C/D (scipy.signal.StateSpace,
    control.StateSpace, or a plain (A, B, C, D) tuple). ``nd`` trailing
    input channels become measured disturbances. Continuous systems
    (``sys.dt`` None/0) are ZOH-discretized with ``Ts``.
    """
    if isinstance(sys, tuple):
        A, B, C, D = (np.atleast_2d(np.asarray(x, dtype=np.float64)) for x in sys)
        dt = None
    else:
        if hasattr(sys, "to_ss"):
            sys = sys.to_ss()
        A = np.atleast_2d(np.asarray(sys.A, dtype=np.float64))
        B = np.atleast_2d(np.asarray(sys.B, dtype=np.float64))
        C = np.atleast_2d(np.asarray(sys.C, dtype=np.float64))
        D = np.atleast_2d(np.asarray(sys.D, dtype=np.float64))
        dt = getattr(sys, "dt", None)

    if np.any(D):
        raise ValueError("Non-proper system (direct feedthrough D != 0) is not supported")

    nu_total = B.shape[1]
    if nd > nu_total:
        raise ValueError("nd exceeds the number of inputs")
    nu = nu_total - nd
    Bu, Bd = B[:, :nu], B[:, nu:]
    Dd = np.zeros((C.shape[0], nd))

    discrete = dt is not None and dt not in (0, 0.0)
    if discrete:
        return make_model(A, Bu, Gd=Bd, C=C, Dd=Dd, Ts=float(dt))
    if Ts is None or Ts <= 0:
        raise ValueError("Continuous system: provide a sample time Ts for ZOH discretization")
    return model_from_continuous(A, Bu, Ts, Bd=Bd, C=C, Dd=Dd)
