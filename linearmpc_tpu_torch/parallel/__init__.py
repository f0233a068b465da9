from .mesh import make_mesh, make_sharded_batch_solver, shard_ldp_arrays

__all__ = ["make_mesh", "make_sharded_batch_solver", "shard_ldp_arrays"]
