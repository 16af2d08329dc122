"""Port of repro/distributed/__init__.py: the serve half of the sharding
rules (``ParallelConfig``, the mesh, the paged cache's placement)."""
from .sharding import (VIRTUAL_DEVICES_ENV, Mesh, NamedSharding,
                       ParallelConfig, ShardedTensor, attention_scheme,
                       axis_size, pieces, replicated, serve_cache_pspec,
                       serve_cache_shardings)

__all__ = [
    "Mesh", "NamedSharding", "ParallelConfig", "ShardedTensor",
    "VIRTUAL_DEVICES_ENV", "attention_scheme", "axis_size", "pieces",
    "replicated", "serve_cache_pspec", "serve_cache_shardings",
]
