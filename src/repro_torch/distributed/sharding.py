"""Port of repro/distributed/sharding.py (the serve half).

Axis roles
----------
  "model"          tensor parallelism (TP): attention heads.
  "data"           data parallelism (the train stack's FSDP; here a
                   replica axis).
  "pod"            (multi-pod mesh only) pure data parallelism across pods.

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
shard's work on the one device. Placements (:class:`ShardedTensor`) move
each piece to its device explicitly, so a host with several cards runs the
same code with the shards apart.

Not ported: the train half (``param_pspec`` / ``param_shardings``,
``batch_pspec``, ``cache_pspec``, ``input_shardings``, ``state_shardings``,
``with_shardings`` and ``ParallelConfig.param_shardings`` /
``state_shardings``). Parameters stay whole on the lead device.
"""
from __future__ import annotations

import dataclasses
import os
from math import prod
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from ..configs.base import ModelConfig

_KNOWN_AXES = ("pod", "data", "model")
# read only by ParallelConfig.build_mesh: that many virtual devices, all on
# the engine's device
VIRTUAL_DEVICES_ENV = "REPRO_TORCH_VIRTUAL_DEVICES"

# a placement spec: one entry per tensor axis, a mesh axis name or None
Spec = Tuple[Optional[str], ...]


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

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """ONE mesh spec (DESIGN.md §9). The serve side consumes it through
    ``core.paths.validate`` -> ``ResolvedPlan.mesh`` and
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
        its own index, and a CPU one the single CPU. Raises ``ValueError``
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


def _maybe(axes, size, mesh) -> Optional[Any]:
    """axes (str or tuple) if their product divides size, else None."""
    t = (axes,) if isinstance(axes, str) else tuple(axes)
    if all(a in mesh.axis_names for a in t) and \
            size % axis_size(mesh, *t) == 0:
        return axes
    return None


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


# ---------------------------------------------------------------------------
# serve-side paged-cache rules (DESIGN.md §9)
# ---------------------------------------------------------------------------


class NamedSharding(NamedTuple):
    """A placement: a spec over a mesh."""

    mesh: Mesh
    spec: Spec

    @property
    def is_fully_replicated(self) -> bool:
        return all(a is None for a in self.spec)


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


def _split(spec: Spec):
    """``(tensor axis, mesh axis)`` that ``spec`` splits, or ``(None,
    None)`` for whole copies. A placed tensor splits at most one axis."""
    split = [(i, a) for i, a in enumerate(spec) if a is not None]
    if len(split) > 1 or not all(isinstance(a, str) for _, a in split):
        raise ValueError(f"a ShardedTensor splits one tensor axis over one "
                         f"mesh axis, not {spec}")
    return split[0] if split else (None, None)


class ShardedTensor:
    """One logical tensor held as one piece per mesh device, placed by
    ``sharding`` (a :class:`NamedSharding`): split on the one tensor axis
    (``axis``) whose spec entry names a mesh axis (``mesh_axis``; device
    ``i`` holds slice ``coords(i)[mesh_axis]``), or, with no such entry, a
    whole copy on every device. ``shape`` is the WHOLE tensor's. Indexing
    with an integer takes that index of the leading axis of every piece (a
    layer of a pool)."""

    __slots__ = ("shards", "sharding", "axis", "mesh_axis")

    def __init__(self, shards, sharding: NamedSharding):
        self.shards = tuple(shards)
        self.sharding = sharding
        self.axis, self.mesh_axis = _split(sharding.spec)

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @classmethod
    def place(cls, x: torch.Tensor,
              sharding: NamedSharding) -> "ShardedTensor":
        """Split (or copy) the whole tensor ``x`` onto the mesh by
        ``sharding``; every piece is contiguous and on its own device."""
        mesh = sharding.mesh
        axis, name = _split(sharding.spec)
        if axis is None:
            return cls([x.to(d, copy=True).contiguous()
                        for d in mesh.devices], sharding)
        parts = x.chunk(mesh.shape[name], dim=axis)
        return cls([parts[mesh.coords(i)[name]].to(d, copy=True).contiguous()
                    for i, d in enumerate(mesh.devices)], sharding)

    @classmethod
    def zeros(cls, shape, sharding: NamedSharding,
              dtype: torch.dtype) -> "ShardedTensor":
        """A zero tensor of whole shape ``shape`` placed by ``sharding``,
        made piece by piece (the whole never exists at once)."""
        axis, name = _split(sharding.spec)
        piece = list(shape)
        if axis is not None:
            piece[axis] //= sharding.mesh.shape[name]
        return cls([torch.zeros(piece, dtype=dtype, device=d)
                    for d in sharding.mesh.devices], sharding)

    @property
    def shape(self) -> torch.Size:
        s = list(self.shards[0].shape)
        if self.axis is not None:
            s[self.axis] *= self.mesh.shape[self.mesh_axis]
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
        if not isinstance(i, int) or self.axis == 0:
            raise TypeError("a ShardedTensor is indexed by one integer on a "
                            "leading axis it is not split on")
        return ShardedTensor([s[i] for s in self.shards], NamedSharding(
            self.mesh, tuple(self.sharding.spec[1:])))

    def read_group(self):
        """``(device index, piece)`` of the pieces one read needs: each
        slice once, from the devices whose other mesh coordinates are 0."""
        if self.axis is None:
            return [(0, self.shards[0])]
        return [(i, self.shards[i])
                for i in self.mesh.axis_group(self.mesh_axis)]

    def gather(self) -> torch.Tensor:
        """The whole tensor on the lead device (pieces concatenated on the
        split axis; a replicated tensor's first copy)."""
        group = self.read_group()
        lead = self.mesh.lead
        if len(group) == 1:
            return group[0][1]
        return torch.cat([s.to(lead) for _, s in group], dim=self.axis)

    def slices(self, n: int):
        """``(device, slice)`` per piece: the range of a length-``n`` axis
        (the whole axis of a copy) that piece ``i`` holds."""
        out = []
        for i, d in enumerate(self.mesh.devices):
            if self.axis is None:
                out.append((d, slice(0, n)))
            else:
                k = self.mesh.shape[self.mesh_axis]
                w = n // k
                j = self.mesh.coords(i)[self.mesh_axis]
                out.append((d, slice(j * w, (j + 1) * w)))
        return out

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, axis={self.axis},"
                f" pieces={len(self.shards)}, dtype={self.dtype})")


def pieces(x):
    """The pieces of a placed tensor, or ``(x,)`` for a plain one."""
    return x.shards if isinstance(x, ShardedTensor) else (x,)


__all__ = [
    "Mesh", "NamedSharding", "ParallelConfig", "ShardedTensor",
    "VIRTUAL_DEVICES_ENV", "attention_scheme", "axis_size", "pieces",
    "replicated", "serve_cache_pspec", "serve_cache_shardings",
]
