"""Plotting: simulations, explicit-MPC partitions, certification maps.

Port of ``linearmpc_tpu/plotting.py``: matplotlib equivalents of the
reference's Plots.jl recipes (src/simulation.jl:151-246,
src/explicit.jl:99-133, src/certify.jl:31-59). The inputs are the port's
``Simulation``, ``ExplicitMPC`` and ``CertificationResult``; any tensor
among their fields is taken to NumPy on the host first. Figures are
returned, never shown, so the module is headless-safe. matplotlib is
imported only when a figure is drawn (``_mpl``), never with the package.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(a) -> np.ndarray:
    """A field of the port's results as a float64 NumPy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def _mpl():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def plot_simulation(sim, *, yids=None, uids=None, xids=None):
    """y/u(/x) subplot stack with references and bounds
    (reference src/simulation.jl:151-246)."""
    plt = _mpl()
    mpc = sim.mpc
    ts, ys, us, xs, rs = (_np(a) for a in (sim.ts, sim.ys, sim.us, sim.xs, sim.rs))
    yids = list(range(ys.shape[0])) if yids is None else list(yids)
    uids = list(range(us.shape[0])) if uids is None else list(uids)
    xids = [] if xids is None else list(xids)

    n = len(yids) + len(uids) + len(xids)
    fig, axes = plt.subplots(n, 1, figsize=(7, 2.2 * n), sharex=True, squeeze=False)
    axes = axes[:, 0]
    labels = mpc.model.labels
    k = 0
    xlab = "Time [s]" if mpc.model.Ts > 0 else "Time step"
    for i in yids:
        ax = axes[k]
        ax.plot(ts, rs[i, :], "k--", lw=0.6, label="reference")
        ax.plot(ts, ys[i, :], lw=1.2)
        ax.set_ylabel(labels.y[i])
        k += 1
    umin = _np(getattr(mpc, "umin", np.zeros(0)))
    umax = _np(getattr(mpc, "umax", np.zeros(0)))
    for i in uids:
        ax = axes[k]
        if len(umin) > i and umin[i] > -1e12:
            ax.axhline(umin[i], color="k", ls="--", lw=0.8)
        if len(umax) > i and umax[i] < 1e12:
            ax.axhline(umax[i], color="k", ls="--", lw=0.8)
        ax.step(ts, us[i, :], where="post", lw=1.2)
        ax.set_ylabel(labels.u[i])
        k += 1
    for i in xids:
        ax = axes[k]
        ax.plot(ts, xs[i, :], lw=1.2)
        ax.set_ylabel(labels.x[i])
        k += 1
    axes[-1].set_xlabel(xlab)
    fig.tight_layout()
    return fig


def _slice_regions(regions, free_ids, fix_vals, nth):
    """Intersect each region with the 2D slice theta[free] variable,
    theta[fixed] = fix_vals; returns 2D polyhedra (A2 x <= b2)."""
    out = []
    fixed_ids = [i for i in range(nth) if i not in free_ids]
    for cr in regions:
        Ath, bth = _np(cr.Ath), _np(cr.bth)
        A2 = Ath[:, free_ids]
        b2 = bth - Ath[:, fixed_ids] @ fix_vals
        out.append((A2, b2, cr))
    return out


def _poly_vertices(A, b, lb, ub):
    """Vertices of {A x <= b} intersected with the box, via pairwise
    hyperplane intersections (2D only)."""
    A = np.vstack([A, np.eye(2), -np.eye(2)])
    b = np.concatenate([b, ub, -lb])
    m = len(b)
    pts = []
    for i in range(m):
        for j in range(i + 1, m):
            M = np.vstack([A[i], A[j]])
            if abs(np.linalg.det(M)) < 1e-10:
                continue
            p = np.linalg.solve(M, np.array([b[i], b[j]]))
            if np.all(A @ p <= b + 1e-7):
                pts.append(p)
    if len(pts) < 3:
        return None
    pts = np.asarray(pts)
    c = pts.mean(axis=0)
    ang = np.arctan2(pts[:, 1] - c[1], pts[:, 0] - c[0])
    return pts[np.argsort(ang)]


def plot_explicit_partition(empc, parameters=(0, 1), *, fix=None):
    """2D slice of the critical-region partition
    (reference src/explicit.jl:99-133)."""
    plt = _mpl()
    free_ids = list(parameters)
    nth = empc.nth
    fix_vals = np.zeros(nth - 2) if fix is None else np.asarray(fix, dtype=np.float64)
    lb = _np(empc.lb)[free_ids]
    ub = _np(empc.ub)[free_ids]

    fig, ax = plt.subplots(figsize=(6, 5))
    cmap = plt.get_cmap("tab20")
    for i, (A2, b2, cr) in enumerate(_slice_regions(empc.regions, free_ids, fix_vals, nth)):
        verts = _poly_vertices(A2, b2, lb, ub)
        if verts is None:
            continue
        ax.fill(verts[:, 0], verts[:, 1], color=cmap(i % 20), alpha=0.6,
                edgecolor="k", lw=0.3)
    names = empc.mpc.get_parameter_names()
    ax.set_xlabel(names[free_ids[0]])
    ax.set_ylabel(names[free_ids[1]])
    ax.set_xlim(lb[0], ub[0])
    ax.set_ylim(lb[1], ub[1])
    ax.set_title(f"{len(empc.regions)} critical regions")
    fig.tight_layout()
    return fig


def plot_explicit_feedback(empc, parameters=(0, 1), control=0, *, fix=None):
    """Piecewise-affine feedback surface u_control(theta) over a 2D
    parameter slice: one 3D facet per critical region (reference explicit
    recipe plots the same PWA surface, src/explicit.jl:97-133)."""
    plt = _mpl()
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    free_ids = list(parameters)
    nth = empc.nth
    fixed_ids = [i for i in range(nth) if i not in free_ids]
    fix_vals = np.zeros(nth - 2) if fix is None else np.asarray(fix, dtype=np.float64)
    lb = _np(empc.lb)[free_ids]
    ub = _np(empc.ub)[free_ids]

    fig = plt.figure(figsize=(7, 5))
    ax = fig.add_subplot(projection="3d")
    cmap = plt.get_cmap("viridis")
    zmin, zmax = np.inf, -np.inf
    facets = []
    for A2, b2, cr in _slice_regions(empc.regions, free_ids, fix_vals, nth):
        verts = _poly_vertices(A2, b2, lb, ub)
        if verts is None:
            continue
        # affine feedback on the slice: u = F[:, free] th2 + F[:, fixed] fv + g
        Fu = _np(cr.F)[control]
        gu = _np(cr.g)[control] + Fu[fixed_ids] @ fix_vals
        z = verts @ Fu[free_ids] + gu
        facets.append(np.column_stack([verts, z]))
        zmin, zmax = min(zmin, z.min()), max(zmax, z.max())
    span = max(zmax - zmin, 1e-12)
    for f3 in facets:
        zc = (f3[:, 2].mean() - zmin) / span
        ax.add_collection3d(Poly3DCollection(
            [f3], facecolors=cmap(zc), edgecolors="k", linewidths=0.3, alpha=0.9))
    names = empc.mpc.get_parameter_names() if empc.mpc is not None else None
    ax.set_xlabel(names[free_ids[0]] if names else f"theta_{free_ids[0]}")
    ax.set_ylabel(names[free_ids[1]] if names else f"theta_{free_ids[1]}")
    ax.set_zlabel(f"u_{control}")
    ax.set_xlim(lb[0], ub[0])
    ax.set_ylim(lb[1], ub[1])
    if facets:  # an empty slice would set_zlim(inf, -inf) and raise
        ax.set_zlim(zmin, zmax)
    ax.set_title(f"PWA feedback over {len(facets)} regions")
    fig.tight_layout()
    return fig


def plot_certification(result, parameters=(0, 1), *, fix=None, resolution=80):
    """Iteration-count map over a 2D parameter slice
    (reference src/certify.jl:31-59). Rasterized: for each grid point the
    max iteration count over containing partition cells."""
    plt = _mpl()
    mpc = result.mpc
    prange = mpc.parameter_range()
    lb, ub = _np(prange.lower()), _np(prange.upper())
    nth = len(lb)
    free = list(parameters)
    fix_vals = np.zeros(nth - 2) if fix is None else np.asarray(fix, dtype=np.float64)
    fixed_ids = [i for i in range(nth) if i not in free]

    xs = np.linspace(lb[free[0]], ub[free[0]], resolution)
    ys = np.linspace(lb[free[1]], ub[free[1]], resolution)
    img = np.zeros((resolution, resolution))
    theta = np.zeros(nth)
    theta[fixed_ids] = fix_vals
    cells = [(_np(cr.Ath), _np(cr.bth), cr.iterations) for cr in result.partition]
    for a, x in enumerate(xs):
        for bcol, y in enumerate(ys):
            theta[free[0]] = x
            theta[free[1]] = y
            best = 0
            for Ath, bth, iterations in cells:
                if np.all(Ath @ theta <= bth + 1e-9):
                    best = max(best, iterations)
            img[bcol, a] = best
    fig, ax = plt.subplots(figsize=(6, 5))
    pc = ax.pcolormesh(xs, ys, img, shading="auto")
    fig.colorbar(pc, ax=ax, label="certified iterations")
    names = mpc.get_parameter_names()
    ax.set_xlabel(names[free[0]])
    ax.set_ylabel(names[free[1]])
    ax.set_title(f"worst case: {result.max_iterations} iterations")
    fig.tight_layout()
    return fig
