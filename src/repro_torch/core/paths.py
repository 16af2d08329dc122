"""Port of repro/core/paths.py (the serving path's share).

Write-path registry: the paper's two-path contract as a pluggable API. A
:class:`WritePath` declares, by name, HOW writes reach memory (``uses_ring``:
straight scatter vs staging-ring overlay with bulk drains) and WHICH routing
decisions it can absorb (``capabilities``); engines are configured from
``(path="adaptive", policy="frequency")`` strings resolved through the
registry. :func:`validate` is the one config -> plan entry point.

Features of the JAX package's ``validate`` that are not ported yet raise
``NotImplementedError("not ported yet: ...")`` at config time: the
``parallel`` mesh, ``spec`` (speculative decoding), ``memory.prefix_cache``
and ``memory.host_tier``, ``chunked=True`` (on either layout), a ``sched``
other than ``"fifo"``, sampled decoding, and
``AttentionConfig.drain_kernel`` (in this package the device decides: a
CUDA tensor drains through the kernel, a CPU tensor through its plain
version).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple, Union

import torch

from .decision import DecisionModule
from .monitor import ExactMonitor
from .policy import get_policy_factory
from .types import resolve_device

CAP_DIRECT = "direct"
CAP_STAGED = "staged"
CAP_BULK_PIN = "bulk-pin"
_KNOWN_CAPS = frozenset({CAP_DIRECT, CAP_STAGED, CAP_BULK_PIN})


@dataclasses.dataclass(frozen=True)
class WritePath:
    """A named KV/memory write mechanism and its negotiation surface.

    name            registry key (and the engine config string).
    capabilities    subset of {direct, staged, bulk-pin}.
    uses_ring       True = writes may ride the staging-ring overlay and the
                    engine must run drain machinery.
    default_policy  RoutingPolicy name paired with this path when the caller
                    names no policy.
    """

    name: str
    capabilities: frozenset
    uses_ring: bool
    default_policy: str
    description: str = ""

    def __post_init__(self):
        unknown = set(self.capabilities) - _KNOWN_CAPS
        if unknown:
            raise ValueError(
                f"write path {self.name!r}: unknown capabilities "
                f"{sorted(unknown)} (known: {sorted(_KNOWN_CAPS)})")
        if CAP_STAGED in self.capabilities and not self.uses_ring:
            raise ValueError(
                f"write path {self.name!r}: the 'staged' capability "
                f"requires uses_ring=True")

    def supports(self, cap: str) -> bool:
        return cap in self.capabilities

    def __repr__(self) -> str:
        caps = ", ".join(sorted(self.capabilities))
        return (f"WritePath(name={self.name!r}, capabilities={{{caps}}}, "
                f"uses_ring={self.uses_ring}, "
                f"default_policy={self.default_policy!r})")


_PATHS: Dict[str, WritePath] = {}


def register_path(path: WritePath, *, overwrite: bool = False) -> WritePath:
    if path.name in _PATHS and not overwrite:
        raise ValueError(
            f"write path {path.name!r} already registered "
            f"(pass overwrite=True to replace it)")
    _PATHS[path.name] = path
    return path


def get_path(name: Union[str, WritePath]) -> WritePath:
    if isinstance(name, WritePath):
        return name
    try:
        return _PATHS[name]
    except KeyError:
        raise ValueError(
            f"unknown write path {name!r}; registered paths: "
            f"{sorted(_PATHS)}") from None


def available_paths() -> Tuple[str, ...]:
    return tuple(sorted(_PATHS))


DIRECT = register_path(WritePath(
    name="direct",
    capabilities=frozenset({CAP_DIRECT, CAP_BULK_PIN}),
    uses_ring=False,
    default_policy="always-offload",
    description="per-write scatter straight to the destination "
                "(the offload/RNIC path)",
))

STAGED = register_path(WritePath(
    name="staged",
    capabilities=frozenset({CAP_STAGED, CAP_BULK_PIN}),
    uses_ring=True,
    default_policy="always-unload",
    description="staging-ring append + bulk drain for every scattered "
                "write (the unload path)",
))

ADAPTIVE = register_path(WritePath(
    name="adaptive",
    capabilities=frozenset({CAP_DIRECT, CAP_STAGED, CAP_BULK_PIN}),
    uses_ring=True,
    default_policy="frequency",
    description="per-write routing between direct scatter and the "
                "staging ring (the paper's composite)",
))


def negotiate(path: WritePath, policy, *, layout: Optional[str] = None,
              chunked: bool = False) -> None:
    """Validate a (path, policy, layout, scheduling) combination; raises
    ``ValueError`` naming the missing capability."""
    emits = getattr(policy, "emits", frozenset({"offload", "unload"}))
    pname = getattr(policy, "name", type(policy).__name__)
    if "unload" in emits and not path.supports(CAP_STAGED):
        raise ValueError(
            f"policy {pname} can route writes to the unload path, but "
            f"write path {path.name!r} lacks the 'staged' capability "
            f"(capabilities: {sorted(path.capabilities)}); pick a "
            f"staged-capable path or an offload-only policy")
    if "offload" in emits and not path.supports(CAP_DIRECT):
        raise ValueError(
            f"policy {pname} can keep scattered writes on the offload "
            f"path, but write path {path.name!r} lacks the 'direct' "
            f"capability (capabilities: {sorted(path.capabilities)}; "
            f"'bulk-pin' covers only phase-tagged bulk writes); pick a "
            f"direct-capable path or an unload-only policy")
    if layout == "lanes" and path.supports(CAP_STAGED):
        raise ValueError(
            f"kv_layout='lanes' is direct-only, but write path "
            f"{path.name!r} carries the 'staged' capability; use "
            f"path='direct' or the paged layout")
    if chunked and not path.supports(CAP_BULK_PIN):
        raise ValueError(
            f"chunked prefill tags bulk writes for offload-path pinning, "
            f"but write path {path.name!r} lacks the 'bulk-pin' "
            f"capability (capabilities: {sorted(path.capabilities)})")


ATTN_FUSED = "fused"
ATTN_REFERENCE = "reference"
_KNOWN_ATTN = ("auto", ATTN_FUSED, ATTN_REFERENCE)


def resolve_attention(attention: str = "auto", *,
                      layout: Optional[str] = None,
                      arch_paged_capable: bool = True,
                      device="cuda") -> str:
    """Negotiate the decode-attention implementation.

    ``fused`` is the ``flash_decode_paged`` read kernel (page-table walk
    over the physical pool, the staging ring as a second softmax source); it
    needs the paged layout. ``reference`` is the gather + concat read path.
    ``auto`` picks fused when the engine's device is CUDA and reference on
    the CPU; ``fused`` on the CPU runs the kernel's plain version.
    ``REPRO_ATTENTION`` overrides ``auto``."""
    if attention not in _KNOWN_ATTN:
        raise ValueError(
            f"unknown attention implementation {attention!r} "
            f"(known: {list(_KNOWN_ATTN)})")
    paged = layout == "paged" and arch_paged_capable
    if attention == ATTN_FUSED and not paged:
        raise ValueError(
            f"attention='fused' needs the paged KV layout to walk "
            f"(layout={layout!r}, paged-capable={arch_paged_capable}); "
            f"use kv_layout='paged' on a dense decoder arch, or "
            f"attention='reference'")
    if attention != "auto":
        return attention
    if not paged:
        return ATTN_REFERENCE
    env = os.environ.get("REPRO_ATTENTION")
    if env is not None:
        return resolve_attention(env, layout=layout,
                                 arch_paged_capable=arch_paged_capable,
                                 device=device)
    return (ATTN_FUSED if torch.device(device).type == "cuda"
            else ATTN_REFERENCE)


# ---------------------------------------------------------------------------
# grouped sub-configs + the single validate() entry point
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MemoryConfig:
    """Memory-capacity feature group. ``prefix_cache`` and ``host_tier`` are
    not ported yet (``validate`` raises when either is on)."""

    prefix_cache: bool = False
    host_tier: bool = False
    skip_ahead_limit: int = 4

    def __post_init__(self):
        if self.skip_ahead_limit < 0:
            raise ValueError(
                f"MemoryConfig.skip_ahead_limit must be >= 0, got "
                f"{self.skip_ahead_limit}")


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    """Read-side implementation group: ``impl`` is ``auto`` | ``fused`` |
    ``reference`` (resolved through :func:`resolve_attention`).
    ``drain_kernel`` must stay ``None``: the drain runs the kernel on a CUDA
    tensor and its plain version on a CPU tensor, nothing else."""

    impl: str = "auto"
    drain_kernel: Optional[bool] = None

    def __post_init__(self):
        if self.impl not in _KNOWN_ATTN:
            raise ValueError(
                f"unknown attention implementation {self.impl!r} "
                f"(known: {list(_KNOWN_ATTN)})")


@dataclasses.dataclass(frozen=True, eq=False)
class ResolvedPlan:
    """Everything an engine needs, resolved and negotiated ONCE by
    :func:`validate`; engines consume only this, never the raw config."""

    layout: str
    attention: str
    path: WritePath
    decision: DecisionModule
    sched: Any
    memory: MemoryConfig
    device: torch.device
    n_blocks: int
    max_pages: int
    n_regions: int


def normalize_groups(cfg) -> None:
    """Shared ``EngineConfig``/``BatchConfig`` ``__post_init__`` normalizer:
    default the grouped sub-configs and coerce an ``attention`` string to
    ``AttentionConfig(impl=...)``."""
    cfg.memory = getattr(cfg, "memory", None) or MemoryConfig()
    a = getattr(cfg, "attention", None)
    cfg.attention = a if isinstance(a, AttentionConfig) else AttentionConfig(
        impl=a or "auto")


def _not_ported(what: str):
    return NotImplementedError(f"not ported yet: {what}")


def validate(cfg, *, paged_capable: bool = True,
             arch_name: Optional[str] = None) -> ResolvedPlan:
    """THE config -> plan entry point: one call, one loud error surface.
    ``cfg`` is duck-typed over ``EngineConfig`` / ``BatchConfig``. Raises
    ``ValueError`` on an incompatible combination and
    ``NotImplementedError`` on a feature this package does not have yet."""
    device = resolve_device(getattr(cfg, "device", "cuda"))
    layout = getattr(cfg, "kv_layout", "auto") or "auto"
    if layout not in ("auto", "paged", "lanes"):
        raise ValueError(
            f"unknown kv_layout {layout!r} (known: auto | paged | lanes)")
    if layout == "auto":
        layout = "paged" if paged_capable else "lanes"
    if layout == "paged" and not paged_capable:
        raise ValueError(
            f"paged KV serves the linear-addressed dense family; "
            f"{arch_name or 'this model'} needs kv_layout='lanes'")
    if bool(getattr(cfg, "chunked", False)):
        raise _not_ported("chunked=True (in-scan chunked prefill)")
    parallel = getattr(cfg, "parallel", None)
    if parallel is not None and getattr(parallel, "enabled", True):
        raise _not_ported("parallel (mesh-sharded serving)")
    spec = getattr(cfg, "spec", None)
    if spec is not None and getattr(spec, "enabled", True):
        raise _not_ported("spec (speculative decoding)")
    memory = getattr(cfg, "memory", None) or MemoryConfig()
    if memory.prefix_cache:
        raise _not_ported("memory.prefix_cache")
    if memory.host_tier:
        raise _not_ported("memory.host_tier")
    attn_cfg = getattr(cfg, "attention", None)
    if not isinstance(attn_cfg, AttentionConfig):
        attn_cfg = AttentionConfig(impl=attn_cfg or "auto")
    if attn_cfg.drain_kernel is not None:
        raise _not_ported(
            "AttentionConfig.drain_kernel (the drain runs the kernel on a "
            "CUDA tensor and its plain version on a CPU tensor)")
    dp = getattr(cfg, "default_params", None)
    if dp is not None and dp.temperature is not None and dp.temperature > 0:
        raise _not_ported("sampled decoding (temperature > 0); greedy only")
    if getattr(cfg, "greedy", True) is False:
        raise _not_ported("sampled decoding (greedy=False); greedy only")
    attention = resolve_attention(attn_cfg.impl, layout=layout,
                                  arch_paged_capable=paged_capable,
                                  device=device)

    # function-level import: core must not import serve at module scope
    from ..serve.traffic.sched import build_sched

    sched = build_sched(getattr(cfg, "sched", None) or "fifo")

    ps = getattr(cfg, "page_size", 8)
    n_slots = getattr(cfg, "n_slots", 8)
    max_pages = -(-int(getattr(cfg, "max_seq")) // int(ps))
    n_blocks = int(getattr(cfg, "n_blocks", 0) or n_slots * max_pages)
    # lanes: one region per (slot, page-sized span of its lane)
    n_regions = n_blocks if layout == "paged" else n_slots * max_pages
    path_name = (getattr(cfg, "path", None)
                 or getattr(cfg, "write_mode", None) or "direct")
    path, decision = build_decision(
        path_name, getattr(cfg, "policy", None), n_regions=n_regions,
        hot_threshold=getattr(cfg, "hot_threshold", 4), layout=layout)
    return ResolvedPlan(
        layout=layout, attention=attention, path=path, decision=decision,
        sched=sched, memory=memory, device=device, n_blocks=n_blocks,
        max_pages=max_pages, n_regions=n_regions)


def build_decision(path: Union[str, WritePath] = "direct",
                   policy: Optional[str] = None, *,
                   n_regions: int,
                   hot_threshold: int = 4,
                   layout: Optional[str] = None,
                   chunked: bool = False,
                   **policy_kw) -> Tuple[WritePath, DecisionModule]:
    """The one (path, policy) -> decision-plane factory: resolves both names
    through their registries, negotiates capabilities, and assembles the
    :class:`DecisionModule` (decide-style policies share the module-level
    monitor so every write heats the counters the engine reads)."""
    wp = get_path(path)
    pol_name = policy or wp.default_policy
    factory = get_policy_factory(pol_name)
    monitor = ExactMonitor(n_regions=n_regions)
    pol = factory(monitor=monitor, n_regions=n_regions,
                  hot_threshold=hot_threshold, **policy_kw)
    negotiate(wp, pol, layout=layout, chunked=chunked)
    if getattr(pol, "owns_state", not hasattr(pol, "decide")):
        module = DecisionModule(policy=pol)
    else:
        module = DecisionModule(policy=pol, monitor=monitor)
    return wp, module


__all__ = [
    "CAP_DIRECT", "CAP_STAGED", "CAP_BULK_PIN",
    "ATTN_FUSED", "ATTN_REFERENCE",
    "WritePath", "register_path", "get_path", "available_paths",
    "DIRECT", "STAGED", "ADAPTIVE",
    "negotiate", "resolve_attention", "resolve_device", "build_decision",
    "MemoryConfig", "AttentionConfig", "ResolvedPlan", "validate",
    "normalize_groups",
]
