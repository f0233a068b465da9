"""Multi-process initialization and batch sharding on ``torch.distributed``.

Port of ``linearmpc_tpu/parallel/distributed.py``. The pattern:

1. every process calls :func:`initialize` at startup with the
   coordinator's ``host:port``, the process count and its own id;
2. :func:`make_global_mesh` builds the (dp, mp) mesh over all processes,
   one device each (keep ``mp`` within a host so its collectives stay on
   NVLink);
3. :func:`shard_batch_across_hosts` makes each process's local batch one
   global ``DTensor`` sharded over ``dp``, torch's counterpart of
   ``jax.make_array_from_process_local_data``; ``full_tensor()`` gathers it
   and ``to_local()`` gives the process its own rows back.

Nothing here tells a program of a cluster: the caller names the
coordinator, the world size and the rank. The backend follows the device,
NCCL on the card and gloo on the CPU.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.engine import resolve_device
from .mesh import BACKENDS, make_mesh, mesh_device


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, device=None) -> None:
    """Join the default process group at ``tcp://coordinator_address``
    (``host:port``) as rank ``process_id`` of ``num_processes``, on the
    backend of ``device`` (the card if not given, which raises without
    CUDA). With one process this is a no-op: ``make_mesh`` sets up a world
    of one itself."""
    if num_processes in (None, 1):
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(BACKENDS[dev.type], init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def make_global_mesh(mp: int = 1, *, device=None):
    """Global (dp, mp) mesh over every process's device; ``mp`` must divide
    the process count."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % mp:
        raise ValueError(f"{mp} must divide {n} processes")
    return make_mesh(n // mp, mp, devices=device)


def shard_batch_across_hosts(mesh, local_batch):
    """The global batch as a ``DTensor`` sharded over ``dp`` (replicated
    over ``mp``), from each process's (b, ...) local rows in rank order."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    local = torch.as_tensor(local_batch, device=mesh_device(mesh))
    return DTensor.from_local(local, mesh, [Shard(0), Replicate()], run_check=False)
