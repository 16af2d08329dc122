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
joined with ``/``) back into such a nested dict, without importing jax.

The writer side, the JAX package's layout and protocol: ``save`` /
``save_async`` write ``<root>/step_%09d/`` (``manifest.json``,
``leaf_%05d.npy``) through a ``.tmp`` directory renamed into place, then
``LATEST``; ``latest_step`` ignores an incomplete step; ``restore`` reads a
step into the structure of a template; ``list_steps`` and ``prune``. Trees
are nested dicts (keys sorted), NamedTuples, lists and tuples of tensors or
arrays, with the leaf keys of JAX's ``_flatten`` (``params/w``, a
NamedTuple's field as ``.field``), so a step that either package writes the
other restores. An object with ``jax_tree(leaf)`` / ``from_jax_tree(tree)``
(``train.TrainState``) is written in the JAX package's structure of the
same thing: its model's parameters stacked per layer
(``models.layout``), its optimizer state likewise, int32 counters. The
manifest's ``treedef`` is descriptive only (neither reader reads it).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..distributed.sharding import ShardedTensor
from ..models.layout import numpy_leaf

_MANIFEST = "manifest.json"
_LATEST = "LATEST"


# ---------------------------------------------------------------------------
# trees <-> flat key / leaf maps (JAX's ``_flatten`` keys)
# ---------------------------------------------------------------------------


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(path component, child) pairs in JAX's flatten order, or None for a
    leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [("." + f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{key: leaf}, keys joined with ``/`` as JAX's ``_flatten`` joins them;
    None is an empty subtree."""
    if tree is None:
        return {}
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    flat: Dict[str, Any] = {}
    for name, child in kids:
        flat.update(_flatten(child, f"{prefix}/{name}" if prefix else name))
    return flat


def _rebuild(template, loaded: Dict[str, Any], leaf, prefix: str = ""):
    """``template``'s structure with each leaf ``leaf(template_leaf,
    loaded[key])``."""
    if template is None:
        return None
    kids = _children(template)
    if kids is None:
        return leaf(template, loaded[prefix])
    vals = [_rebuild(c, loaded, leaf, f"{prefix}/{n}" if prefix else n)
            for n, c in kids]
    if isinstance(template, dict):
        return dict(zip(sorted(template), vals))
    if _is_namedtuple(template):
        return type(template)(*vals)
    return type(template)(vals)


def _to_host(x):
    """A host copy of ``x`` that shares no memory with it (a CPU tensor's
    ``.numpy()`` would: an in-place update after ``save_async`` returns
    would reach the snapshot)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


def _host_tree(tree):
    """The tree on the host: numpy leaves; an object with ``jax_tree``
    becomes the JAX package's structure of it."""
    if hasattr(tree, "jax_tree"):
        tree = tree.jax_tree(numpy_leaf)
    if tree is None:
        return None
    if _children(tree) is None:
        return _to_host(tree)
    return _rebuild(tree, _flatten(tree), lambda _, v: _to_host(v))


class _Spec:
    """A leaf's shape and numpy dtype (what ``restore`` checks a file
    against)."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = tuple(shape), np.dtype(dtype)


_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
              torch.float16: np.float16, torch.int32: np.int32,
              torch.int64: np.int64, torch.bool: np.bool_,
              torch.int8: np.int8, torch.uint8: np.uint8}


def _spec(x) -> _Spec:
    if isinstance(x, (torch.Tensor, ShardedTensor)):
        return _Spec(x.shape, _NP_DTYPES[x.dtype])
    x = np.asarray(x) if not hasattr(x, "dtype") else x
    return _Spec(x.shape, x.dtype)


def _spec_leaf(values, stacked: bool) -> _Spec:
    one = _spec(values[0])
    return _Spec(((len(values),) if stacked else ()) + one.shape, one.dtype)


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------


def save(root: str, step: int, tree: Any) -> str:
    """Synchronous atomic save. Returns the final directory path."""
    return _write(root, step, _host_tree(tree))


def save_async(root: str, step: int, tree: Any) -> threading.Thread:
    """Snapshot to host memory now (a copy: the caller may change its
    tensors right after); write in the background."""
    host = _host_tree(tree)
    t = threading.Thread(target=_write, args=(root, step, host), daemon=True)
    t.start()
    return t


def _write(root: str, step: int, host_tree: Any) -> str:
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    flat = _flatten(host_tree)
    manifest = {
        "step": step,
        "treedef": f"repro_torch {type(host_tree).__name__} of "
                   f"{len(flat)} leaves",
        "keys": list(flat.keys()),
        "leaves": {},
    }
    for i, (key, leaf) in enumerate(flat.items()):
        fname = f"leaf_{i:05d}.npy"
        arr = np.asarray(leaf)
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {
            "file": fname,
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
        }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    with open(os.path.join(root, _LATEST + ".tmp"), "w") as f:
        f.write(os.path.basename(final))
    os.replace(os.path.join(root, _LATEST + ".tmp"), os.path.join(root, _LATEST))
    return final


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------


def latest_step(root: str) -> Optional[int]:
    path = os.path.join(root, _LATEST)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(root, name, _MANIFEST)):
        return None  # LATEST points at an incomplete/garbage dir
    return int(name.split("_")[-1])


def _as_template_leaf(want, arr: np.ndarray):
    """``arr`` as the template's leaf kind: a tensor of its dtype on its
    device, or a numpy array."""
    if isinstance(want, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(
            device=want.device, dtype=want.dtype)
    return arr


def restore(root: str, template: Any, step: Optional[int] = None) -> Any:
    """Restore step ``step`` (default: the latest complete one) into the
    structure of ``template`` (a tree of tensors or arrays; tensors come
    back on their template's device and dtype), or into an object with
    ``jax_tree`` / ``from_jax_tree``, which returns what it makes of the
    JAX-structured tree. Every file is cast to its template leaf's dtype, as
    the JAX package's ``restore`` does; a key set or a shape that differs
    raises ``ValueError``."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {root}")
    d = os.path.join(root, f"step_{step:09d}")
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)

    structured = hasattr(template, "jax_tree")
    spec_tree = template.jax_tree(_spec_leaf) if structured else template
    flat_t = _flatten(spec_tree)
    if set(flat_t) != set(manifest["leaves"]):
        missing = set(flat_t) ^ set(manifest["leaves"])
        raise ValueError(f"checkpoint/template structure mismatch: "
                         f"{sorted(missing)[:5]}")
    loaded = {}
    for key, meta in manifest["leaves"].items():
        arr = np.load(os.path.join(d, meta["file"]))
        want = _spec(flat_t[key])
        if tuple(arr.shape) != want.shape:
            raise ValueError(f"{key}: shape {arr.shape} != template "
                             f"{want.shape}")
        loaded[key] = arr.astype(want.dtype)
    if structured:
        return template.from_jax_tree(
            _rebuild(spec_tree, loaded, lambda _, v: v))
    return _rebuild(template, loaded, _as_template_leaf)


def list_steps(root: str):
    if not os.path.isdir(root):
        return []
    out = []
    for name in sorted(os.listdir(root)):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(root, name, _MANIFEST)):
                out.append(int(name.split("_")[-1]))
    return out


def prune(root: str, keep: int = 3):
    """Delete all but the newest ``keep`` complete checkpoints."""
    steps = list_steps(root)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(root, f"step_{s:09d}"), ignore_errors=True)


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
