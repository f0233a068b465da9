"""What the per-layer readers under ``layers/`` share: each reads one
metric from a traced window (``Context.trace``), the units it ran, and
the reference statistics of the output check (``Context.stats``), and
returns None when there is nothing to read."""

from __future__ import annotations

import re

import numpy as np

from mpcbench import trace as tr
from mpcbench import workmodel as wm

K3 = re.compile(r"(?<![A-Za-z0-9_])iu_kernel")
SEARCH = re.compile(r"(?<![A-Za-z0-9_])search_kernel")


def idle_pct(ctx):
    lo, hi = ctx.trace.window
    if not ctx.trace.device or hi <= lo:
        return None
    return 100.0 * (1.0 - tr.busy_seconds(ctx.trace) / (hi - lo))


def kernel_seconds(ctx, pattern) -> float:
    return sum(k.end - k.start for k in ctx.trace.kernels(pattern.search))


def launches(ctx) -> int:
    return len(ctx.trace.kernels())


def _bytes(ctx, lanes_per_call: int, calls: int) -> float:
    s = ctx.shapes
    statics = wm.statics_bytes(s["m"], s["n"], s["n_theta"])
    return calls * wm.solve_bytes(s["m"], s["n"], s["n_theta"], lanes_per_call, statics)


def cold_roofline(ctx, pattern):
    """Roofline share of the kernel ``pattern`` in a batch cell: every lane
    builds the reference's optimal working set from empty."""
    sizes = ctx.stats.get("ws_sizes") or []
    if not sizes:
        return None
    m, B = ctx.shapes["m"], int(ctx.params["batch"])
    lanes = ctx.units * B
    flops = lanes * float(np.mean([wm.cold_flops(m, w) for w in sizes]))
    return wm.roofline_pct(flops, _bytes(ctx, B, ctx.units), kernel_seconds(ctx, pattern))


def warm_roofline(ctx, pattern):
    """Roofline share of the kernel ``pattern`` in a closed-loop cell: each
    lane-step adds the rows new to the reference's working set."""
    sizes, added = ctx.stats.get("ws_sizes") or [], ctx.stats.get("added") or []
    if not sizes:
        return None
    m, B, N = ctx.shapes["m"], int(ctx.params["lanes"]), int(ctx.params["steps"])
    per = float(np.mean([wm.warm_flops(m, w, a) for w, a in zip(sizes, added)]))
    return wm.roofline_pct(ctx.units * B * N * per, _bytes(ctx, B, ctx.units * N),
                           kernel_seconds(ctx, pattern))


def search_roofline(ctx, pattern):
    """Roofline share of the search kernel: the reference's own
    branch-and-bound iterations and nodes a checked lane, scaled to the
    lanes run."""
    work, nodes = ctx.stats.get("work") or [], ctx.stats.get("nodes") or []
    if not work:
        return None
    m, n, B = ctx.shapes["m"], ctx.shapes["n"], int(ctx.params["batch"])
    per = float(np.mean([wm.iterations_flops(m, sw, sw2) + k * wm.management_flops(m, n)
                         for (_, sw, sw2), k in zip(work, nodes)]))
    return wm.roofline_pct(ctx.units * B * per, _bytes(ctx, B, ctx.units),
                           kernel_seconds(ctx, pattern))


def after_kernel_ms(ctx, pattern):
    """Mean ms from the last ``pattern`` kernel's end to the end of the
    program call that launched it."""
    gaps = []
    for c in ctx.trace.calls:
        ks = ctx.trace.kernels(pattern.search, c.start, c.end)
        if ks:
            gaps.append(c.end - max(k.end for k in ks))
    return 1e3 * float(np.mean(gaps)) if gaps else None


def host_ms(ctx):
    """Mean ms of a program call less the device-busy time inside it."""
    vals = [(c.end - c.start) - tr.busy_seconds(ctx.trace, c.start, c.end) for c in ctx.trace.calls]
    return 1e3 * float(np.mean(vals)) if vals and ctx.trace.device else None
