"""Port of repro/distributed/__init__.py: the sharding rules
(``ParallelConfig``, the mesh, parameter / batch / cache / train-state
placement, the paged cache's placement) and the collectives of a sharded
train step, each counting the bytes it moves."""
from .collectives import collective_bytes, reset_collective_counts
from .sharding import (VIRTUAL_DEVICES_ENV, Mesh, NamedSharding,
                       ParallelConfig, ShapeDtypeStruct, ShardedTensor,
                       attention_scheme, axis_size, batch_pspec, cache_pspec,
                       dp_axes, input_shardings, layer_pspec,
                       make_abstract_mesh, param_pspec, param_shardings,
                       pieces, replicated, serve_cache_pspec,
                       serve_cache_shardings, state_pspec, state_shardings,
                       tree_paths_and_leaves, with_shardings)

__all__ = [
    "Mesh", "NamedSharding", "ParallelConfig", "ShapeDtypeStruct",
    "ShardedTensor", "VIRTUAL_DEVICES_ENV", "attention_scheme", "axis_size",
    "batch_pspec", "cache_pspec", "collective_bytes",
    "dp_axes", "input_shardings", "layer_pspec", "make_abstract_mesh",
    "param_pspec", "param_shardings", "pieces", "replicated",
    "reset_collective_counts", "serve_cache_pspec", "serve_cache_shardings",
    "state_pspec", "state_shardings", "tree_paths_and_leaves",
    "with_shardings",
]
