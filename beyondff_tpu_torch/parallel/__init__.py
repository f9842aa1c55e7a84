"""Multi-rank parallelism on torch.distributed: the (model, data) mesh, the
tensor-parallel rule, the frame-sharded lift and the multi-process dry run.

The reference is strictly single-GPU sequential. Here frames shard over the
``data`` axis with ``all_reduce`` summing per-point vote counts, and model
Linears can shard over the ``model`` axis for tensor parallelism.
"""

from beyondff_tpu_torch.parallel.mesh import data_sharding, make_mesh, replicated  # noqa: F401
