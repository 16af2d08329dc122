"""Port of repro/checkpoint/checkpoint.py (the reader side) and the weight
bridge from the JAX package's parameter layout.

``params_from_numpy(tree, model)`` loads a nested dict of numpy arrays in
the JAX layout into the port's ``DecoderLM``, ``MoELM``, ``MambaLM``,
``ZambaLM`` or ``WhisperModel``::

    embed/{tok, head}           [V, D]
    ln_f/{scale, bias}          [D]
    blocks/ln1|ln2/{scale,bias} [L, D]          (stacked on a layer axis)
    blocks/attn/{wq,wk,wv}      [L, D, H, Dh]   blocks/attn/wo [L, Hq, Dh, D]
    blocks/attn/{bq,bk,bv}      [L, H, Dh]      (qkv_bias archs only)
    blocks/mlp/{wi,wg}          [L, D, F]       blocks/mlp/wo  [L, F, D]
    blocks/moe/router           [L, D, E]       (MoE in place of mlp)
    blocks/moe/{wi,wg}          [L, E, D, F]    blocks/moe/wo  [L, E, F, D]

    the mamba2 blocks (ssm, hybrid): leaves flat under blocks/
    blocks/ln/{scale,bias}      [L, D]
    blocks/in_proj              [L, D, 2 d_in + 2 G N + H]
    blocks/conv_w               [L, W, Ch]      blocks/conv_b  [L, Ch]
    blocks/{A_log,dt_bias,D}    [L, H]          blocks/norm    [L, d_in]
    blocks/out_proj             [L, d_in, D]

    the hybrid's one shared block (unstacked): shared/ln1, shared/attn,
    shared/ln2, shared/mlp with the shapes above less the layer axis

    the VLM: the self layers under blocks/, its cross layers beside them
    cross_blocks/{ln1,attn,ln2,mlp}             [G, ...] as blocks/
    cross_blocks/{gate_attn,gate_mlp}           [G]     (0-d gates, stacked)

    the encoder-decoder (whisper): two stacks in place of blocks/
    enc_pos                     [F, D]          dec_pos  [max(P, max_seq), D]
    ln_enc/{scale,bias}         [D]
    enc_blocks/{ln1,attn,ln2,mlp}               [L_enc, ...] as blocks/
    dec_blocks/{ln1,self_attn,ln2,cross_attn,ln3,mlp}  [L, ...] (attn shapes)

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


def _load_stack(stack: Dict[str, Any], blocks, where: str, t) -> None:
    """One ``[L, ...]`` stack of block parameters into ``blocks`` (an
    ``nn.ModuleList``): every group loads into the block module of its name,
    the leaves flat under the stack (the mamba2 blocks') into the block
    itself."""
    n_layers = len(blocks)
    groups = {k: v for k, v in stack.items() if isinstance(v, dict)}
    flat = {k: v for k, v in stack.items() if not isinstance(v, dict)}
    for name, leaf in [(f"{g}/{k}", v) for g, grp in groups.items()
                       for k, v in grp.items()] + list(flat.items()):
        if np.asarray(leaf).shape[0] != n_layers:
            raise ValueError(
                f"{where}/{name}: leading axis {np.asarray(leaf).shape[0]} "
                f"!= n_layers {n_layers}")
    for i, blk in enumerate(blocks):
        for name, group in groups.items():
            getattr(blk, name).load({k: t(np.asarray(v)[i])
                                     for k, v in group.items()})
        if flat:
            blk.load({k: t(np.asarray(v)[i]) for k, v in flat.items()})


def params_from_numpy(tree: Dict[str, Any], model) -> Any:
    """Load a JAX-layout parameter tree (see the module docstring) into
    ``model`` (a ``repro_torch`` ``DecoderLM``, ``MoELM``, ``MambaLM``,
    ``ZambaLM`` or ``WhisperModel``), in place; returns it. Each stack
    (``blocks``, the VLM's ``cross_blocks``, or whisper's ``enc_blocks``
    and ``dec_blocks``) loads into the module list of its name, the positions tables (``enc_pos``,
    ``dec_pos``) and ``ln_enc`` into the model's own, and ``shared`` (the
    hybrid's shared block) into ``model.shared``."""
    dev = model.device

    def t(a):
        return torch.tensor(np.array(a, dtype=np.float32), device=dev)

    model.embed.load({k: t(v) for k, v in tree["embed"].items()})
    model.ln_f.load({k: t(v) for k, v in tree["ln_f"].items()})
    for name in ("blocks", "cross_blocks", "enc_blocks", "dec_blocks"):
        if name in tree:
            _load_stack(tree[name], getattr(model, name), name, t)
    if "ln_enc" in tree:
        model.ln_enc.load({k: t(v) for k, v in tree["ln_enc"].items()})
    for name in ("enc_pos", "dec_pos"):
        if name in tree:
            own = getattr(model, name)
            if tuple(np.shape(tree[name])) != tuple(own.shape):
                raise ValueError(f"{name}: shape {np.shape(tree[name])} != "
                                 f"{tuple(own.shape)}")
            with torch.no_grad():
                own.copy_(t(tree[name]))
    if "shared" in tree:
        for name, group in tree["shared"].items():
            getattr(model.shared, name).load(
                {k: t(v) for k, v in group.items()})
    return model
