"""Port of repro/checkpoint/checkpoint.py (the reader side) and the weight
bridge from the JAX package's parameter layout.

``params_from_numpy(tree, model)`` loads a nested dict of numpy arrays in
the JAX layout into the port's ``DecoderLM`` or ``MoELM``::

    embed/{tok, head}           [V, D]
    ln_f/{scale, bias}          [D]
    blocks/ln1|ln2/{scale,bias} [L, D]          (stacked on a layer axis)
    blocks/attn/{wq,wk,wv}      [L, D, H, Dh]   blocks/attn/wo [L, Hq, Dh, D]
    blocks/attn/{bq,bk,bv}      [L, H, Dh]      (qkv_bias archs only)
    blocks/mlp/{wi,wg}          [L, D, F]       blocks/mlp/wo  [L, F, D]
    blocks/moe/router           [L, D, E]       (MoE in place of mlp)
    blocks/moe/{wi,wg}          [L, E, D, F]    blocks/moe/wo  [L, E, F, D]

``load_checkpoint(dir)`` reads one step directory of the JAX package's
checkpoint layout (``manifest.json`` + one ``leaf_*.npy`` per leaf, keys
joined with ``/``) back into such a nested dict, without importing jax. The
writer side (atomic / async save, elastic restore) is not ported yet.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

_MANIFEST = "manifest.json"
_LATEST = "LATEST"


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Nested dict of numpy arrays from a step directory (or from a
    checkpoint root, following its ``LATEST`` file)."""
    if not os.path.exists(os.path.join(path, _MANIFEST)):
        latest = os.path.join(path, _LATEST)
        if not os.path.exists(latest):
            raise FileNotFoundError(
                f"{path}: neither {_MANIFEST} nor {_LATEST} found")
        with open(latest) as f:
            path = os.path.join(path, f.read().strip())
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    tree: Dict[str, Any] = {}
    for key in manifest["keys"]:
        meta = manifest["leaves"][key]
        arr = np.load(os.path.join(path, meta["file"]))
        if list(arr.shape) != list(meta["shape"]):
            raise ValueError(f"{key}: file shape {arr.shape} != manifest "
                             f"{meta['shape']}")
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def params_from_numpy(tree: Dict[str, Any], model) -> Any:
    """Load a JAX-layout parameter tree (see the module docstring) into
    ``model`` (a ``repro_torch`` ``DecoderLM`` or ``MoELM``), in place;
    returns it. Every group under ``blocks`` loads into the block module of
    its name."""
    dev = model.device

    def t(a):
        return torch.tensor(np.array(a, dtype=np.float32), device=dev)

    model.embed.load({k: t(v) for k, v in tree["embed"].items()})
    model.ln_f.load({k: t(v) for k, v in tree["ln_f"].items()})
    blocks = tree["blocks"]
    n_layers = len(model.blocks)
    for name, group in blocks.items():
        for k, v in group.items():
            if np.asarray(v).shape[0] != n_layers:
                raise ValueError(
                    f"blocks/{name}/{k}: leading axis "
                    f"{np.asarray(v).shape[0]} != n_layers {n_layers}")
        for i, blk in enumerate(model.blocks):
            getattr(blk, name).load({k: t(np.asarray(v)[i])
                                     for k, v in group.items()})
    return model
