"""Distribution on ``torch.distributed``: sharding rules as DTensor
placements, expert parallelism, gradient compression.

A port of ``repro/distributed``.  The reference's ``compat.shard_map``
(a JAX-version spelling shim for ``shard_map``) has no counterpart: the
port's collectives are ``torch.distributed`` calls on process groups,
and :func:`use_mesh` takes the place of ``with mesh:``.
"""

from .compression import (compressed_psum, compressed_psum_tree,
                          dequantize_blockwise, psum_bytes_saved,
                          quantize_blockwise)
from .expert_parallel import apply_moe_ep
from .sharding import (NamedSharding, PartitionSpec, batch_pspecs,
                       cache_pspecs, current_mesh, distribute_tree,
                       optimizer_pspecs, param_pspec, params_pspecs,
                       sharded_step, sharded_zeros, to_named,
                       to_placements, use_mesh)

__all__ = [
    "NamedSharding", "PartitionSpec", "apply_moe_ep", "batch_pspecs",
    "cache_pspecs", "compressed_psum", "compressed_psum_tree",
    "current_mesh", "dequantize_blockwise", "distribute_tree",
    "optimizer_pspecs", "param_pspec", "params_pspecs", "psum_bytes_saved",
    "quantize_blockwise", "sharded_step", "sharded_zeros", "to_named",
    "to_placements", "use_mesh",
]
