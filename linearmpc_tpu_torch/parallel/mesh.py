"""Device meshes and the dp-sharded batched solve on ``torch.distributed``.

Port of ``linearmpc_tpu/parallel/mesh.py``. The scenario batch is
data-parallel over the ``dp`` axis of a (dp, mp) ``DeviceMesh``; the
constraint-row dimension can be split over ``mp`` (``shard_ldp_arrays``,
and the row-sharded solver of ``parallel/schur.py``). One process drives
one device, so the mesh spans the processes of the default process group:
NCCL on the card, gloo on the CPU. Where no process group exists yet,
``make_mesh`` sets up a world of one rank with an in-process store.

``make_sharded_batch_solver`` gives each dp rank its slice of the batch,
which it solves with batched ``solve_single`` on its device (the kernels
on the card), and gathers the results over dp, where the JAX package
leaves the placement to GSPMD.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..ops.dual_active_set import LDPArrays, Solution, solve_single
from ..ops.engine import resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def ensure_process_group(device_type: str) -> None:
    """The default process group; a world of one rank with an in-process
    store where none exists yet (no address, no network)."""
    if not dist.is_initialized():
        dist.init_process_group(BACKENDS[device_type], store=dist.HashStore(),
                                rank=0, world_size=1)


def make_mesh(dp: int | None = None, mp: int = 1, devices=None) -> DeviceMesh:
    """A (dp, mp) mesh, dims named ("dp", "mp"), over the ranks of the
    default process group. ``devices`` names the device type ("cuda" or
    "cpu"; the card if not given, which raises without CUDA); ``dp``
    defaults to the world size over ``mp``."""
    device_type = resolve_device(devices).type
    ensure_process_group(device_type)
    n = dist.get_world_size()
    if dp is None:
        dp = n // mp
    if dp * mp != n:
        raise ValueError(f"mesh {dp}x{mp} != {n} ranks")
    return init_device_mesh(device_type, (dp, mp), mesh_dim_names=("dp", "mp"))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank drives on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_ldp_arrays(arrays: LDPArrays, mesh: DeviceMesh) -> LDPArrays:
    """Place solver arrays on the mesh as ``DTensor``s: constraint-row
    sharded over ``mp`` where the leading axis is the m dimension (and m
    divides by mp), replicated otherwise. The host mask copies stay as they
    are."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    m = arrays.G.shape[0]
    mp = mesh.size(1)
    host = {"is_eq_host", "is_immutable_host"}

    def place(name, a):
        if a is None or name in host:
            return a
        rows = a.dim() >= 1 and a.shape[0] == m and m % mp == 0 and m > 0
        return distribute_tensor(a, mesh, [Replicate(), Shard(0) if rows else Replicate()])

    return LDPArrays(*(place(f, a) for f, a in zip(LDPArrays._fields, arrays)))


def dp_slice(mesh: DeviceMesh, B: int) -> slice:
    """This rank's rows of a global batch of B lanes (B divisible by dp)."""
    dp = mesh.size(0)
    if B % dp:
        raise ValueError(f"batch {B} does not divide over dp={dp}")
    b = B // dp
    i = mesh.get_local_rank("dp")
    return slice(i * b, (i + 1) * b)


def gather_dp(mesh: DeviceMesh, t: torch.Tensor) -> torch.Tensor:
    """Concatenate each dp rank's (b, ...) block along the batch, on every
    rank (bool travels as uint8)."""
    dp = mesh.size(0)
    if dp == 1:
        return t
    src = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    out = src.new_empty((dp * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=mesh.get_group("dp"))
    return out.to(torch.bool) if t.dtype == torch.bool else out


def make_sharded_batch_solver(engine, mesh: DeviceMesh, **solve_kw):
    """Batched solve with the theta batch sharded over ``dp``: each rank
    solves its slice of the (B, n_theta) batch with ``solve_single`` on the
    engine's device and the results are gathered over dp. The engine's
    ``solve_single`` keywords, updated by ``solve_kw``, apply."""
    kw = dict(engine._single_kw)
    kw.update(solve_kw)
    in_dtype = torch.float64 if engine.tier else engine.dtype

    def sharded_solve(thetas) -> Solution:
        thetas = torch.as_tensor(thetas, device=engine.device).to(in_dtype)
        sol = solve_single(engine.arrays, thetas[dp_slice(mesh, thetas.shape[0])], **kw)
        return Solution(*(gather_dp(mesh, t) for t in sol))

    return sharded_solve
