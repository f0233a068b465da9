"""Host-side linear-algebra helpers (offline/setup path, NumPy float64).

Equivalents of the reference's offline numerics (carried over from
``linearmpc_tpu/utils/linalg.py``; only ``host_jacobian`` changed):
  * ``zoh``       -- zero-order-hold discretization (reference: src/utils.jl:291-295)
  * ``dare``      -- discrete algebraic Riccati solver replacing MatrixEquations.ared
                     (used by reference src/setup.jl:176,197 and src/observer.jl:65)
  * ``matrixify`` -- scalar/vector/matrix coercion to a weight matrix
                     (reference: src/utils.jl:297-299)

Everything here runs once per problem at setup time on the host; the online
path never calls into this module.
"""

from __future__ import annotations

import numpy as np


def matrixify(x, n: int | None = None) -> np.ndarray:
    """Coerce a scalar/vector/matrix weight spec into a dense float64 matrix.

    A scalar becomes ``x*I(n)``; a vector becomes ``diag(x)``; a matrix is
    passed through (cast to float64). Mirrors reference src/utils.jl:297-299.
    """
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 0:
        if n is None:
            raise ValueError("matrixify of a scalar needs a dimension n")
        return np.diag(np.full(n, float(x)))
    if x.ndim == 1:
        return np.diag(x)
    return x


def zoh(A, B, Ts: float) -> tuple[np.ndarray, np.ndarray]:
    """Zero-order-hold discretization of (A, B) with sample time Ts.

    Returns (F, G) with F = expm(A*Ts) and G the held-input response,
    computed jointly via the block-matrix exponential
    (reference: src/utils.jl:291-295).
    """
    from scipy.linalg import expm

    A = np.atleast_2d(np.asarray(A, dtype=np.float64))
    B = np.asarray(B, dtype=np.float64)
    if B.ndim == 1:
        B = B[:, None]
    nx, nu = B.shape
    M = np.zeros((nx + nu, nx + nu))
    M[:nx, :nx] = A * Ts
    M[:nx, nx:] = B * Ts
    E = expm(M)
    return E[:nx, :nx], E[:nx, nx:]


def dare(F, G, R, Q) -> tuple[np.ndarray, np.ndarray]:
    """Solve the discrete algebraic Riccati equation.

        P = F'PF - F'PG (R + G'PG)^-1 G'PF + Q

    Returns ``(P, K)`` where ``K = (R + G'PG)^-1 G'PF`` is the associated
    LQR gain. Replaces MatrixEquations.ared in the reference
    (src/setup.jl:176,197; src/observer.jl:65).
    """
    from scipy.linalg import solve_discrete_are

    F = np.atleast_2d(np.asarray(F, dtype=np.float64))
    G = np.asarray(G, dtype=np.float64)
    if G.ndim == 1:
        G = G[:, None]
    R = np.atleast_2d(np.asarray(R, dtype=np.float64))
    Q = np.atleast_2d(np.asarray(Q, dtype=np.float64))
    P = solve_discrete_are(F, G, Q, R)
    K = np.linalg.solve(R + G.T @ P @ G, G.T @ P @ F)
    return P, K


def kalman_gain(F, C, Q, R) -> np.ndarray:
    """Steady-state Kalman gain K = P C' (C P C' + R)^-1 from the dual DARE.

    Mirrors reference src/observer.jl:65-67 (``P,_ = ared(F',C',R,Q)``).
    """
    F = np.atleast_2d(np.asarray(F, dtype=np.float64))
    C = np.atleast_2d(np.asarray(C, dtype=np.float64))
    P, _ = dare(F.T, C.T, R, Q)
    return P @ C.T @ np.linalg.inv(C @ P @ C.T + R)


def host_jacobian(fun, z0: np.ndarray) -> np.ndarray:
    """Exact (AD) Jacobian of ``fun`` at ``z0``, evaluated in float64 on CPU.

    Replaces ForwardDiff.jacobian in the reference (src/model.jl:103,108).
    Uses ``torch.func.jacfwd`` on a float64 CPU tensor, so linearization
    stays exact regardless of the accelerator's default precision. ``fun``
    takes and returns torch tensors.
    """
    import torch

    z0 = torch.as_tensor(np.asarray(z0, dtype=np.float64), dtype=torch.float64)
    J = torch.func.jacfwd(fun)(z0)
    return J.detach().cpu().numpy().astype(np.float64)
