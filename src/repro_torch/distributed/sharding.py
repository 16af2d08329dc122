"""Port of repro/distributed/sharding.py: the logical sharding rules.

Axis roles
----------
  "model"          tensor parallelism (TP): attention heads or head_dim,
                   MLP hidden, experts (EP), vocab, per divisibility.
  "data"           FSDP for parameters and optimizer state, batch data
                   parallelism for activations.
  "pod"            (multi-pod mesh only) pure data parallelism across pods:
                   parameters replicated across pods, gradients summed over
                   ("pod",) as well.

Divisibility-driven schemes (as in the JAX package):
* attention: shard heads when Hq % TP == 0 and Hkv % TP == 0; else shard
  q heads and replicate the kv projections when Hq % TP == 0; else shard
  head_dim when Dh % TP == 0; else replicate;
* vocab: shard the output head's V over ``model`` when divisible, else its
  D; the lookup table ``tok`` never on its V;
* experts: EP over ``model`` when E % TP == 0, else TP inside the expert
  FFN (its ff) when divisible;
* KV caches at decode: heads over ``model`` when Hkv % TP == 0, else the
  sequence; batch over ("pod", "data") when divisible; batch 1 (long_500k)
  shards the sequence over every axis.

A spec is a tuple with one entry per tensor axis: ``None``, one mesh axis
name, or a tuple of names (``("pod", "data")``), as a JAX ``PartitionSpec``.
Trees are the JAX package's layouts (nested dicts, NamedTuples such as its
``TrainState``), their paths joined with ``/`` as ``tree_paths_and_leaves``
joins them; a port parameter maps to its path by ``models.layout.jax_key``.

Serving under a mesh (DESIGN.md §9): the paged pool and the staging ring
split on their HEAD axis across the ``model`` axis when ``Hkv`` divides it
(else every device holds a whole copy); the decision plane (page table,
ring cursors, monitor, stats) stays whole on the lead device, so the host
decides once and every shard follows. Each shard's drain scatters only its
own head slice: the paper's keep-the-unload-local contract under TP.

A :class:`Mesh` here is a grid of ``torch.device`` entries, one process.
:meth:`ParallelConfig.build_mesh` takes the card's distinct devices, or,
where the environment variable ``REPRO_TORCH_VIRTUAL_DEVICES`` is set, that
many VIRTUAL devices, all the engine's own device (the counterpart of
``XLA_FLAGS=--xla_force_host_platform_device_count``): the same code, each
shard's work on the one device. :func:`make_abstract_mesh` builds one over
the ``meta`` device, so the rules run without a device. Placements
(:class:`ShardedTensor`) move each piece to its device explicitly, so a host
with several cards runs the same code with the shards apart.
"""
from __future__ import annotations

import dataclasses
import os
from math import prod
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import torch

from ..configs.base import ModelConfig

_KNOWN_AXES = ("pod", "data", "model")
# read only by ParallelConfig.build_mesh: that many virtual devices, all on
# the engine's device
VIRTUAL_DEVICES_ENV = "REPRO_TORCH_VIRTUAL_DEVICES"

# a placement spec: one entry per tensor axis, None, a mesh axis name or a
# tuple of mesh axis names
Spec = Tuple[Any, ...]


class Mesh:
    """A grid of devices with named axes. ``devices`` is the flat tuple in
    row-major order of ``shape`` (``{axis name: size}``, like a JAX mesh's
    ``shape``). Device ``i`` sits at ``coords(i)``."""

    def __init__(self, devices: Sequence[torch.device],
                 mesh_shape: Sequence[int], axis_names: Sequence[str]):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in mesh_shape)))
        if len(self.devices) != prod(self.shape.values()):
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"shape {self.shape}")
        # device coordinates and read groups, worked out once (the serving
        # step asks for them per layer)
        self._coords = []
        for i in range(len(self.devices)):
            c = {}
            for name in reversed(self.axis_names):
                i, c[name] = divmod(i, self.shape[name])
            self._coords.append(c)
        self._groups = {
            axis: [i for i, c in enumerate(self._coords)
                   if all(v == 0 for k, v in c.items() if k != axis)]
            for axis in self.axis_names}
        self._all_groups: Dict[Tuple[str, ...], list] = {}

    @property
    def lead(self) -> torch.device:
        """Where the decision plane, the parameters and the gathered reads
        live: device 0."""
        return self.devices[0]

    def coords(self, i: int) -> Dict[str, int]:
        return self._coords[i]

    def axis_group(self, axis: str):
        """Indices of the devices along ``axis`` whose other coordinates
        are 0, in ``axis`` order: where one read over ``axis`` runs."""
        return self._groups[axis]

    def index(self, i: int, axes: Sequence[str]) -> int:
        """Device ``i``'s position along ``axes`` taken together, row-major
        in the order given (the piece of an axis split by the tuple
        ``axes``)."""
        j = 0
        for a in axes:
            j = j * self.shape[a] + self._coords[i][a]
        return j

    def groups(self, axes: Sequence[str]):
        """Every group of devices that differ only along ``axes`` (axes not
        in the mesh are left out): a list of device-index lists, each in
        the order of :meth:`index` along ``axes``. Every device is in one
        group; with no axis each group is one device."""
        axes = tuple(a for a in axes if a in self.shape)
        if axes not in self._all_groups:
            out: Dict[tuple, list] = {}
            for i, c in enumerate(self._coords):
                key = tuple(v for k, v in c.items() if k not in axes)
                out.setdefault(key, []).append(i)
            self._all_groups[axes] = [
                sorted(g, key=lambda i: self.index(i, axes))
                for g in out.values()]
        return self._all_groups[axes]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


def make_abstract_mesh(axis_sizes: Sequence[int],
                       axis_names: Sequence[str]) -> Mesh:
    """A mesh that needs no device (every entry the ``meta`` device): what
    the rules read is its shape and axis names."""
    return Mesh([torch.device("meta")] * prod(int(s) for s in axis_sizes),
                axis_sizes, axis_names)


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """ONE mesh spec driving both stacks (DESIGN.md §9). The train side
    consumes it through :meth:`param_shardings` / :meth:`state_shardings`
    (and ``train.init_train_state(..., parallel=)``); the serve side
    through ``core.paths.validate`` -> ``ResolvedPlan.mesh`` and
    :meth:`cache_shardings` (the paged pool / staging-ring placement).

    The default ``(1,)`` mesh means "single device": ``build_mesh`` returns
    ``None`` and every consumer takes its unsharded path."""

    mesh_shape: Tuple[int, ...] = (1,)
    axis_names: Tuple[str, ...] = ("model",)

    def __post_init__(self):
        shape = tuple(int(s) for s in self.mesh_shape)
        names = tuple(str(a) for a in self.axis_names)
        object.__setattr__(self, "mesh_shape", shape)
        object.__setattr__(self, "axis_names", names)
        if len(shape) != len(names):
            raise ValueError(
                f"ParallelConfig: mesh_shape {shape} and axis_names "
                f"{names} disagree on rank")
        if len(set(names)) != len(names):
            raise ValueError(f"ParallelConfig: duplicate axis in {names}")
        unknown = set(names) - set(_KNOWN_AXES)
        if unknown:
            raise ValueError(
                f"ParallelConfig: unknown axis names {sorted(unknown)} "
                f"(known roles: {list(_KNOWN_AXES)})")
        if any(s < 1 for s in shape):
            raise ValueError(
                f"ParallelConfig: axis sizes must be >= 1, got {shape}")

    @classmethod
    def tensor(cls, tp: int) -> "ParallelConfig":
        """Pure tensor parallelism: a 1-D ``("model",)`` mesh of ``tp``."""
        return cls(mesh_shape=(tp,), axis_names=("model",))

    @property
    def n_devices(self) -> int:
        return prod(self.mesh_shape)

    @property
    def tp(self) -> int:
        """Size of the ``model`` axis (1 when the mesh has none)."""
        if "model" not in self.axis_names:
            return 1
        return self.mesh_shape[self.axis_names.index("model")]

    @property
    def enabled(self) -> bool:
        return self.n_devices > 1

    def build_mesh(self, devices=None, *, device="cuda") -> Optional[Mesh]:
        """A :class:`Mesh` over ``devices``, or ``None`` for the trivial
        (single-device) spec. Without ``devices`` the mesh starts at
        ``device`` (the engine's), so its lead is where the engine's
        parameters and decision plane live: ``REPRO_TORCH_VIRTUAL_DEVICES=N``
        gives N virtual devices, each ``device``; else a CUDA ``device``
        takes the ``torch.cuda.device_count()`` distinct cards, starting at
        its own index, a ``meta`` one as many ``meta`` devices as the spec
        needs (an abstract mesh), and a CPU one the single CPU. Raises
        ``ValueError``
        when there are fewer devices than the spec needs: the mesh is never
        shrunk."""
        if not self.enabled:
            return None
        if devices is None:
            dev = torch.device(device)
            n_cards = (torch.cuda.device_count() if dev.type == "cuda"
                       else 0)
            if dev.type == "cuda" and dev.index is None and n_cards:
                dev = torch.device("cuda", torch.cuda.current_device())
            virtual = os.environ.get(VIRTUAL_DEVICES_ENV)
            if virtual:
                devices = [dev] * int(virtual)
            elif dev.type == "meta":
                devices = [dev] * self.n_devices
            elif dev.type == "cuda":
                devices = [torch.device("cuda", (dev.index + i) % n_cards)
                           for i in range(n_cards)]
            else:
                devices = [dev]
        if len(devices) < self.n_devices:
            raise ValueError(
                f"ParallelConfig{self.mesh_shape}x{self.axis_names} needs "
                f"{self.n_devices} devices but the platform exposes "
                f"{len(devices)}; set {VIRTUAL_DEVICES_ENV}="
                f"{self.n_devices} for that many virtual devices on the "
                f"engine's device, or shrink the mesh")
        return Mesh(list(devices)[: self.n_devices], self.mesh_shape,
                    self.axis_names)

    # the one-spec-drives-both-stacks surface
    def param_shardings(self, cfg: ModelConfig, abstract_params: Any,
                        devices=None, *, device="cuda") -> Optional[Any]:
        """Train / serve parameter placement from this spec (None =
        trivial)."""
        mesh = self.build_mesh(devices, device=device)
        if mesh is None:
            return None
        return param_shardings(cfg, mesh, abstract_params)

    def state_shardings(self, cfg: ModelConfig, abstract_state: Any,
                        devices=None, *, device="cuda") -> Optional[Any]:
        """Train-state placement (params + opt moments) from this spec."""
        mesh = self.build_mesh(devices, device=device)
        if mesh is None:
            return None
        return state_shardings(cfg, mesh, abstract_state)

    def cache_shardings(self, cfg: Optional[ModelConfig], cache: Any,
                        devices=None, *, device="cuda") -> Optional[Any]:
        """Serve-side paged-cache placement from this spec."""
        mesh = self.build_mesh(devices, device=device)
        if mesh is None:
            return None
        return serve_cache_shardings(cfg, mesh, cache)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def axis_size(mesh, *names: str) -> int:
    return prod(mesh.shape[n] for n in names if n in mesh.axis_names)


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _maybe(axes, size, mesh) -> Optional[Any]:
    """axes (str or tuple) if their product divides size, else None."""
    t = (axes,) if isinstance(axes, str) else tuple(axes)
    if all(a in mesh.axis_names for a in t) and \
            size % axis_size(mesh, *t) == 0:
        return axes
    return None


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry: () for None."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def attention_scheme(cfg: ModelConfig, mesh) -> str:
    m = axis_size(mesh, "model")
    if cfg.n_heads == 0:
        return "none"
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if hq % m == 0 and hkv % m == 0:
        return "heads"
    if hq % m == 0:
        return "qheads_kvrepl"
    if dh % m == 0:
        return "headdim"
    return "replicate"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A placement: a spec over a mesh."""

    mesh: Mesh
    spec: Spec

    @property
    def is_fully_replicated(self) -> bool:
        return all(a is None for a in self.spec)


@dataclasses.dataclass(frozen=True)
class ShapeDtypeStruct:
    """An abstract leaf with its placement (``with_shardings``,
    ``input_shardings``)."""

    shape: Tuple[int, ...]
    dtype: Any
    sharding: Optional[NamedSharding] = None


# ---------------------------------------------------------------------------
# trees in the JAX package's layouts
# ---------------------------------------------------------------------------


def _children(tree):
    """(path component, child) pairs in JAX's flatten order, or None for a
    leaf: a dict by sorted key, a NamedTuple by field, a list or tuple by
    index."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def tree_paths_and_leaves(tree: Any, prefix: str = "") -> Iterator:
    """``(path, leaf)`` for every leaf of ``tree`` in JAX's flatten order,
    the path's keys joined with ``/`` (a NamedTuple field by its name);
    None is an empty subtree."""
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for name, child in kids:
        yield from tree_paths_and_leaves(
            child, f"{prefix}/{name}" if prefix else name)


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: Any,
                       prefix: str = "") -> Any:
    """``tree``'s structure with each leaf ``fn(path, leaf)``."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    vals = [tree_map_with_path(fn, c, f"{prefix}/{n}" if prefix else n)
            for n, c in kids]
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), vals))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*vals)
    return type(tree)(vals)


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------


def param_pspec(cfg: ModelConfig, mesh, path: str,
                shape: Tuple[int, ...]) -> Spec:
    """The spec of one parameter leaf, keyed on its JAX tree path."""
    name = path.split("/")[-1]
    parent = path.split("/")[-2] if "/" in path else ""
    scheme = attention_scheme(cfg, mesh)

    # ---- embeddings / head ----
    if name == "tok":
        # the LOOKUP table: never its vocab (a gather over a vocab-split
        # table replicates it); D over model keeps the lookup local, the
        # residual stream gathers D
        v, d = shape
        return (None, _maybe("model", d, mesh) or _maybe("data", d, mesh))
    if name == "head":
        # the OUTPUT projection: vocab parallelism (logits and the loss's
        # reductions split over V)
        v, d = shape
        vs = _maybe("model", v, mesh)
        if vs:
            return (vs, _maybe("data", d, mesh))
        return (None, _maybe("model", d, mesh) or _maybe("data", d, mesh))

    # ---- attention projections ----
    if name in ("wq", "wk", "wv"):
        d, h, k = shape[-3:]
        lead = (None,) * (len(shape) - 3)  # stacked layer dims
        fs = _maybe("data", d, mesh)
        if scheme == "heads" or (scheme == "qheads_kvrepl" and name == "wq"):
            return (*lead, fs, _maybe("model", h, mesh), None)
        if scheme == "headdim":
            return (*lead, fs, None, _maybe("model", k, mesh))
        return (*lead, fs, None, None)
    if name in ("bq", "bk", "bv"):
        h, k = shape[-2:]
        lead = (None,) * (len(shape) - 2)
        if scheme == "heads" or (scheme == "qheads_kvrepl" and name == "bq"):
            return (*lead, _maybe("model", h, mesh), None)
        if scheme == "headdim":
            return (*lead, None, _maybe("model", k, mesh))
        return (*lead, None, None)
    if name == "wo" and parent in ("attn", "self_attn", "cross_attn"):
        h, k, d = shape[-3:]
        lead = (None,) * (len(shape) - 3)
        fs = _maybe("data", d, mesh)
        if scheme in ("heads", "qheads_kvrepl"):
            return (*lead, _maybe("model", h, mesh), None, fs)
        if scheme == "headdim":
            return (*lead, None, _maybe("model", k, mesh), fs)
        return (*lead, None, None, fs)

    # ---- MoE ----
    if name == "router":
        lead = (None,) * (len(shape) - 2)
        return (*lead, _maybe("data", shape[-2], mesh), None)
    if parent == "moe" and name in ("wi", "wg"):
        e, d, ff = shape[-3:]
        lead = (None,) * (len(shape) - 3)
        ep = _maybe("model", e, mesh)
        if ep:
            return (*lead, ep, _maybe("data", d, mesh), None)
        return (*lead, None, _maybe("data", d, mesh),
                _maybe("model", ff, mesh))
    if parent == "moe" and name == "wo":
        e, ff, d = shape[-3:]
        lead = (None,) * (len(shape) - 3)
        ep = _maybe("model", e, mesh)
        if ep:
            return (*lead, ep, None, _maybe("data", d, mesh))
        return (*lead, None, _maybe("model", ff, mesh),
                _maybe("data", d, mesh))

    # ---- dense MLP ----
    if name in ("wi", "wg"):
        d, ff = shape[-2:]
        lead = (None,) * (len(shape) - 2)
        return (*lead, _maybe("data", d, mesh), _maybe("model", ff, mesh))
    if name == "wo":
        ff, d = shape[-2:]
        lead = (None,) * (len(shape) - 2)
        return (*lead, _maybe("model", ff, mesh), _maybe("data", d, mesh))

    # ---- mamba ----
    if name == "in_proj":
        d, k = shape[-2:]
        lead = (None,) * (len(shape) - 2)
        return (*lead, _maybe("data", d, mesh), None)
    if name == "out_proj":
        k, d = shape[-2:]
        lead = (None,) * (len(shape) - 2)
        return (*lead, None, _maybe("data", d, mesh))

    # ---- positions (replicated: small or latency-critical) / norms / rest
    return (None,) * len(shape)


def param_shardings(cfg: ModelConfig, mesh, abstract_params: Any) -> Any:
    """The placement tree of the (abstract) parameters: each leaf a
    :class:`NamedSharding` by :func:`param_pspec`."""
    return tree_map_with_path(
        lambda k, v: NamedSharding(mesh, param_pspec(cfg, mesh, k,
                                                     tuple(v.shape))),
        abstract_params)


# ---------------------------------------------------------------------------
# batch / cache rules
# ---------------------------------------------------------------------------


def _dp_for_batch(mesh, b: int):
    axes = dp_axes(mesh)
    if axes and b % axis_size(mesh, *axes) == 0:
        return axes if len(axes) > 1 else axes[0]
    if "data" in mesh.axis_names and b % axis_size(mesh, "data") == 0:
        return "data"
    return None


def batch_pspec(cfg: Optional[ModelConfig], mesh, path: str, shape) -> Spec:
    """Inputs: tokens / labels / media / pos (batch-leading)."""
    dp = _dp_for_batch(mesh, shape[0]) if len(shape) else None
    return (dp, *((None,) * (len(shape) - 1)))


def cache_pspec(cfg: Optional[ModelConfig], mesh, path: str, shape) -> Spec:
    """Decode caches: [L, B, S, H, K] kv, [L, B, H, P, N] ssm, etc."""
    name = path.split("/")[-1]
    m = axis_size(mesh, "model")
    if name in ("k", "v", "cross_k", "cross_v", "ring_k", "ring_v"):
        l, b, s, h, k = shape
        dp = _dp_for_batch(mesh, b)
        if name in ("ring_k", "ring_v"):
            return (None, dp, None, _maybe("model", h, mesh), None)
        if dp is None:
            # long_500k (B = 1): the sequence over every available axis
            all_ax = tuple(a for a in ("pod", "data", "model")
                           if a in mesh.axis_names)
            return (None, None,
                    _maybe(all_ax, s, mesh) or _maybe("model", s, mesh),
                    _maybe("model", h, mesh)
                    if not _maybe(all_ax, s, mesh) else None,
                    None)
        if h % m == 0:
            return (None, dp, None, "model", None)
        return (None, dp, _maybe("model", s, mesh), None, None)
    if name == "ssm":
        l, b, h, p_, n = shape
        dp = _dp_for_batch(mesh, b)
        return (None, dp, _maybe("model", h, mesh), None, None)
    if name == "conv":
        dp = _dp_for_batch(mesh, shape[1])
        return (None, dp, *((None,) * (len(shape) - 2)))
    if name in ("ring_slot",):
        dp = _dp_for_batch(mesh, shape[0])
        return (dp, None)
    if name == "ring_fill":
        return ()
    # fallback: batch-leading
    return batch_pspec(cfg, mesh, path, shape)


def input_shardings(cfg: ModelConfig, mesh, specs: Any, step: str) -> Any:
    """The input-spec tree of a dry-run cell with placements attached:
    ``cache*`` leaves by :func:`cache_pspec`, the rest by
    :func:`batch_pspec`."""

    def one(key, leaf):
        if key.startswith("cache"):
            ps = cache_pspec(cfg, mesh, key, leaf.shape)
        else:
            ps = batch_pspec(cfg, mesh, key, leaf.shape)
        return ShapeDtypeStruct(tuple(leaf.shape), leaf.dtype,
                                NamedSharding(mesh, ps))

    return tree_map_with_path(one, specs)


# ---------------------------------------------------------------------------
# train-state rules
# ---------------------------------------------------------------------------


def state_pspec(cfg: ModelConfig, mesh, key: str, shape) -> Spec:
    """One train-state leaf (a path of the JAX ``TrainState``): the
    parameters and the AdamW moments by :func:`param_pspec`, the scalars
    and the monitor's arrays replicated."""
    if key.startswith(("params", "opt/mu", "opt/nu")):
        pkey = key.split("/", 1)[1]
        if pkey.startswith(("mu/", "nu/")):
            pkey = pkey.split("/", 1)[1]
        return param_pspec(cfg, mesh, pkey, tuple(shape))
    return (None,) * len(shape)


def state_shardings(cfg: ModelConfig, mesh, abstract_state: Any) -> Any:
    """TrainState: params + opt moments follow the param rules; scalars and
    monitor arrays replicate."""
    return tree_map_with_path(
        lambda k, v: NamedSharding(mesh, state_pspec(cfg, mesh, k, v.shape)),
        abstract_state)


def with_shardings(abstract: Any, shardings: Any) -> Any:
    """The abstract tree with the placements of ``shardings`` (a tree of
    the same structure) attached."""
    flat = dict(tree_paths_and_leaves(shardings))
    return tree_map_with_path(
        lambda k, a: ShapeDtypeStruct(tuple(a.shape), a.dtype, flat[k]),
        abstract)


def layer_pspec(cfg: ModelConfig, mesh, name: str, shape) -> Spec:
    """The spec of one parameter of a port model (``blocks.3.attn.wq``):
    its JAX leaf's by :func:`param_pspec`, less the stacked layer axis for a
    layer of a stack (whose entry is always None)."""
    from ..models.layout import jax_key

    key, layer = jax_key(name)
    shape = tuple(shape)
    if layer is None:
        return param_pspec(cfg, mesh, key, shape)
    spec = param_pspec(cfg, mesh, key, (1,) + shape)
    if spec[0] is not None:
        raise ValueError(f"{key}: the layer axis is split ({spec})")
    return tuple(spec[1:])


# ---------------------------------------------------------------------------
# serve-side paged-cache rules (DESIGN.md §9)
# ---------------------------------------------------------------------------


def serve_cache_pspec(cfg: Optional[ModelConfig], mesh, name: str,
                      shape) -> Spec:
    """Placement spec of one SERVE-layer paged-cache leaf.

    Data planes shard on the HEAD axis (axis 3 of both the pool's [L,
    n_blocks, ps, H, Dh] and the ring's [L, n_slots, R, H, Dh]) when Hkv
    divides the model-axis size. Everything the host mutates between
    segments (page table, ring metadata / cursor) replicates: the decision
    plane stays identical on every shard, so drains never move data across
    shard boundaries."""
    if name in ("pages_k", "pages_v", "ring_k", "ring_v"):
        h = shape[3]
        return (None, None, None, _maybe("model", h, mesh), None)
    return (None,) * len(shape)


def serve_cache_shardings(cfg: Optional[ModelConfig], mesh: Mesh,
                          cache: Any) -> Dict[str, NamedSharding]:
    """Placement of each leaf of a ``kvcache.paged`` cache (a leaf may be a
    tensor or just its shape: ``make_paged_kv`` places the planes before
    they exist)."""
    return {k: NamedSharding(mesh, serve_cache_pspec(
        cfg, mesh, k, getattr(v, "shape", v))) for k, v in cache.items()}


def replicated(mesh: Mesh) -> NamedSharding:
    """The fully replicated placement (the decision plane's)."""
    return NamedSharding(mesh, ())


# ---------------------------------------------------------------------------
# placed tensors
# ---------------------------------------------------------------------------


def spec_splits(spec: Spec, mesh) -> Tuple[Tuple[int, Tuple[str, ...]], ...]:
    """``(tensor axis, mesh axes)`` of each tensor axis that ``spec``
    splits, in tensor-axis order. A mesh axis splits at most one tensor
    axis, and every axis named must be the mesh's."""
    out, used = [], set()
    for i, entry in enumerate(spec):
        axes = entry_axes(entry)
        if not axes:
            continue
        for a in axes:
            if a in used:
                raise ValueError(f"a mesh axis splits one tensor axis: "
                                 f"{spec} names {a!r} twice")
            if a not in mesh.shape:
                raise ValueError(f"{spec} names {a!r}, not an axis of "
                                 f"{mesh}")
            used.add(a)
        out.append((i, axes))
    return tuple(out)


class ShardedTensor:
    """One logical tensor held as one piece per mesh device, placed by
    ``sharding`` (a :class:`NamedSharding`): each tensor axis whose spec
    entry names mesh axes is split into as many equal parts as those axes
    have devices together (device ``i`` holds part ``mesh.index(i, axes)``
    of it), the others whole; with no such entry every device holds a
    whole copy. ``shape`` is the WHOLE tensor's. ``splits`` lists ``(tensor
    axis, mesh axes)``; ``axis`` / ``mesh_axis`` are the one split's tensor
    axis and spec entry (None for a copy; tuples where several axes are
    split). Indexing with an integer takes that index of the leading axis
    of every piece (a layer of a pool)."""

    __slots__ = ("shards", "sharding", "splits", "axis", "mesh_axis")

    def __init__(self, shards, sharding: NamedSharding):
        self.shards = tuple(shards)
        self.sharding = sharding
        self.splits = spec_splits(sharding.spec, sharding.mesh)
        if len(self.splits) == 1:
            self.axis = self.splits[0][0]
            self.mesh_axis = sharding.spec[self.axis]
        elif not self.splits:
            self.axis = self.mesh_axis = None
        else:
            self.axis = tuple(a for a, _ in self.splits)
            self.mesh_axis = tuple(sharding.spec[a] for a in self.axis)

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    def parts(self, i: int) -> Tuple[Tuple[int, int, int], ...]:
        """``(tensor axis, part, parts)`` of device ``i``'s piece on each
        split axis."""
        mesh = self.mesh
        return tuple((ax, mesh.index(i, axes), axis_size(mesh, *axes))
                     for ax, axes in self.splits)

    @classmethod
    def place(cls, x: torch.Tensor,
              sharding: NamedSharding) -> "ShardedTensor":
        """Split (or copy) the whole tensor ``x`` onto the mesh by
        ``sharding``; every piece is contiguous and on its own device.
        Raises ``ValueError`` where a split does not divide its axis."""
        mesh = sharding.mesh
        splits = spec_splits(sharding.spec, mesh)
        for ax, axes in splits:
            if x.shape[ax] % axis_size(mesh, *axes):
                raise ValueError(f"{tuple(x.shape)}: axis {ax} does not "
                                 f"divide over {axes}")
        out = []
        for i, d in enumerate(mesh.devices):
            piece = x
            for ax, axes in splits:
                n = axis_size(mesh, *axes)
                w = x.shape[ax] // n
                piece = piece.narrow(ax, mesh.index(i, axes) * w, w)
            out.append(piece.to(d, copy=True).contiguous())
        return cls(out, sharding)

    @classmethod
    def zeros(cls, shape, sharding: NamedSharding,
              dtype: torch.dtype) -> "ShardedTensor":
        """A zero tensor of whole shape ``shape`` placed by ``sharding``,
        made piece by piece (the whole never exists at once)."""
        mesh = sharding.mesh
        piece = list(shape)
        for ax, axes in spec_splits(sharding.spec, mesh):
            piece[ax] //= axis_size(mesh, *axes)
        return cls([torch.zeros(piece, dtype=dtype, device=d)
                    for d in mesh.devices], sharding)

    @property
    def shape(self) -> torch.Size:
        s = list(self.shards[0].shape)
        for ax, axes in self.splits:
            s[ax] *= axis_size(self.mesh, *axes)
        return torch.Size(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    def dim(self) -> int:
        return self.shards[0].dim()

    def element_size(self) -> int:
        return self.shards[0].element_size()

    def __getitem__(self, i: int) -> "ShardedTensor":
        if not isinstance(i, int) or any(ax == 0 for ax, _ in self.splits):
            raise TypeError("a ShardedTensor is indexed by one integer on a "
                            "leading axis it is not split on")
        return ShardedTensor([s[i] for s in self.shards], NamedSharding(
            self.mesh, tuple(self.sharding.spec[1:])))

    def read_group(self):
        """``(device index, piece)`` of the pieces one read needs: each
        part once, from the devices whose coordinates on the mesh axes
        that split nothing are 0."""
        split = {a for _, axes in self.splits for a in axes}
        return [(i, p) for i, p in enumerate(self.shards)
                if all(v == 0 for k, v in self.mesh.coords(i).items()
                       if k not in split)]

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (the lead device by default):
        the pieces of :meth:`read_group` joined on every split axis; a
        replicated tensor's first copy."""
        group = self.read_group()
        dev = torch.device(device) if device is not None else self.mesh.lead
        if len(group) == 1:
            return group[0][1].to(dev)
        blocks = {tuple(j for _, j, _ in self.parts(i)): p
                  for i, p in group}

        def join(prefix, depth):
            if depth == len(self.splits):
                return blocks[prefix].to(dev)
            ax, axes = self.splits[depth]
            return torch.cat([join(prefix + (j,), depth + 1)
                              for j in range(axis_size(self.mesh, *axes))],
                             dim=ax)
        return join((), 0)

    def slices(self, n: int, axis: Optional[int] = None):
        """``(device, slice)`` per piece: the range of a length-``n`` tensor
        axis ``axis`` (by default the one split axis; the whole axis of a
        copy) that piece ``i`` holds."""
        if axis is None:
            if len(self.splits) > 1:
                raise ValueError("slices of which axis? the tensor is split "
                                 f"on {self.axis}")
            axis = self.axis
        out = []
        for i, d in enumerate(self.mesh.devices):
            part = [(j, k) for ax, j, k in self.parts(i) if ax == axis]
            if not part:
                out.append((d, slice(0, n)))
            else:
                j, k = part[0]
                w = n // k
                out.append((d, slice(j * w, (j + 1) * w)))
        return out

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, "
                f"spec={self.sharding.spec}, pieces={len(self.shards)}, "
                f"dtype={self.dtype})")


def pieces(x):
    """The pieces of a placed tensor, or ``(x,)`` for a plain one."""
    return x.shards if isinstance(x, ShardedTensor) else (x,)


__all__ = [
    "Mesh", "NamedSharding", "ParallelConfig", "ShapeDtypeStruct",
    "ShardedTensor", "VIRTUAL_DEVICES_ENV", "attention_scheme", "axis_size",
    "batch_pspec", "cache_pspec", "dp_axes", "entry_axes", "input_shardings",
    "layer_pspec", "make_abstract_mesh", "param_pspec", "param_shardings",
    "pieces", "replicated", "serve_cache_pspec", "serve_cache_shardings",
    "spec_splits", "state_pspec", "state_shardings", "tree_map_with_path",
    "tree_paths_and_leaves", "with_shardings",
]
