"""The JAX package's parameter layout of a port model.

The port keeps one module per layer (``blocks.3.attn.wq``), where the JAX
package stacks a stack's layers on a leading axis (``blocks/attn/wq``
``[L, D, H, Dh]``). ``jax_key`` maps a parameter name of the port to its
JAX leaf key and its index on the stacked axis; ``jax_tree`` builds the JAX
package's nested tree from any per-parameter mapping (the masters, their
gradients, the optimizer's moments) and ``from_jax_tree`` reads one back.
``params_from_numpy`` (``checkpoint``) loads the masters themselves by the
same table.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

# the stacks whose layers the JAX package stacks on axis 0
STACKS = ("blocks", "cross_blocks", "enc_blocks", "dec_blocks")


def jax_key(name: str) -> Tuple[str, Optional[int]]:
    """``blocks.3.attn.wq`` -> ``("blocks/attn/wq", 3)``; a parameter
    outside a stack (``embed.tok``, ``shared.attn.wq``) -> ``(key, None)``."""
    parts = name.split(".")
    if parts[0] in STACKS and len(parts) > 2 and parts[1].isdigit():
        return "/".join([parts[0]] + parts[2:]), int(parts[1])
    return "/".join(parts), None


def jax_ndim(name: str, shape) -> int:
    """The rank of the parameter's leaf in the JAX layout: one more than
    the port's for a layer of a stack."""
    return len(shape) + (jax_key(name)[1] is not None)


def jax_tree(named: Iterable[Tuple[str, Any]],
             leaf: Callable[[List[Any], bool], Any]) -> Dict[str, Any]:
    """The nested JAX-layout tree of ``named`` ((port name, value) pairs):
    each leaf is ``leaf(values, stacked)``, the values of one key in layer
    order (``stacked`` True) or its one value."""
    groups: Dict[str, list] = {}
    for name, value in named:
        key, layer = jax_key(name)
        groups.setdefault(key, []).append((layer, value))
    tree: Dict[str, Any] = {}
    for key, items in groups.items():
        layers = [layer for layer, _ in items]
        stacked = layers[0] is not None
        if stacked and sorted(layers) != list(range(len(layers))):
            raise ValueError(f"{key}: layers {sorted(layers)} are not 0..L-1")
        values = [v for _, v in sorted(items, key=lambda lv: lv[0] or 0)]
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf(values, stacked)
    return tree


def numpy_leaf(values: List[Any], stacked: bool) -> np.ndarray:
    """A ``jax_tree`` leaf on the host, a copy that shares no memory with
    the tensors (stacked on a new axis 0 for a stack); a placed tensor
    (``ShardedTensor``) is gathered whole onto the host first."""
    from ..distributed.sharding import ShardedTensor

    arrs = [v.gather("cpu").detach().numpy() if isinstance(v, ShardedTensor)
            else v.detach().cpu().numpy() if hasattr(v, "detach") else v
            for v in values]
    return np.stack(arrs) if stacked else np.array(arrs[0])


def from_jax_tree(tree: Dict[str, Any], names: Iterable[str]) -> Dict[str, Any]:
    """Each port name's value out of a JAX-layout tree: the leaf of its key,
    indexed by its layer for a stack."""
    out = {}
    for name in names:
        key, layer = jax_key(name)
        node = tree
        for p in key.split("/"):
            node = node[p]
        out[name] = node if layer is None else np.asarray(node)[layer]
    return out
