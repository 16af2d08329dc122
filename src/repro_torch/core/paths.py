"""Port of repro/core/paths.py (the serving path's share).

Write-path registry: the paper's two-path contract as a pluggable API. A
:class:`WritePath` declares, by name, HOW writes reach memory (``uses_ring``:
straight scatter vs staging-ring overlay with bulk drains) and WHICH routing
decisions it can absorb (``capabilities``); engines are configured from
``(path="adaptive", policy="frequency")`` strings resolved through the
registry. :func:`validate` is the one config -> plan entry point.

``AttentionConfig.drain_kernel`` raises ``NotImplementedError`` at config
time (in this package the device decides: a CUDA tensor drains through the
kernel, a CPU tensor through its plain version). As in the JAX package,
``sched="sched/preempt"`` without ``memory.host_tier`` raises ``ValueError``,
and so do the mesh's conflicts (a mesh with the lanes layout, fused
attention over heads the ``model`` axis does not divide, a mesh with more
devices than there are) and speculative decoding's (``SpecConfig``: the
lanes layout has no chunk verifier, ``k < 1``, a draft that shares no
vocabulary with the target or cannot be rolled back). A draft arch this
package does not have, and a recurrent (SSM) draft, raise
``NotImplementedError("not ported yet: ...")``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..distributed.sharding import ParallelConfig
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


def negotiate_memory(*, layout: Optional[str] = None, chunked: bool = False,
                     prefix_cache: bool = False,
                     host_tier: bool = False) -> None:
    """Validate the memory-capacity feature set against the KV layout.

    ``prefix_cache`` (refcounted shared-prefix block reuse) needs the paged
    layout (sharing is a page-table indirection; dense lanes have none) AND
    chunked prefill: a cache hit is consumed by starting the in-segment
    chunk cursor past the cached rows, and the blocking engine's
    admission-time prefill has no partial-prompt entry point. ``host_tier``
    (parking cold slots' blocks device -> host and paging them back) needs
    the paged layout too: parking swaps page-table entries, not lanes."""
    if prefix_cache and layout != "paged":
        raise ValueError(
            f"prefix_cache shares physical blocks through the page table, "
            f"but kv_layout={layout!r} has none; use the paged layout "
            f"(dense non-SWA DecoderLM family)")
    if prefix_cache and not chunked:
        raise ValueError(
            "prefix_cache needs chunked=True: a cache hit starts the "
            "in-scan prefill cursor past the cached rows, and only the "
            "mixed-phase scheduler can enter a prompt mid-way")
    if host_tier and layout != "paged":
        raise ValueError(
            f"host_tier parks and restores physical blocks through the "
            f"page table, but kv_layout={layout!r} has none; use the "
            f"paged layout")


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
    """Memory-capacity feature group: ``prefix_cache`` (shared prompt
    blocks, copy-on-write; paged + chunked), ``host_tier`` (park and restore
    whole slots through host memory; paged) and the admission scan's
    ``skip_ahead_limit``."""

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


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding group (the third execution path, DESIGN.md
    §11): a small draft model proposes ``k`` tokens per live slot inside
    the segment and the target verifies all of them in ONE
    ``decode_chunk_paged`` call, committing the accepted prefix plus one
    target-sampled token.

    ``draft_arch`` names the proposer from the config registry
    (``repro_torch.configs.ARCHS``); ``None`` means self-draft, the target
    model drafting for itself. The draft must share the target's
    vocabulary: :func:`resolve_draft` matches the target's actual vocab
    against the draft's full and reduced configs and :func:`validate`
    rejects when neither fits."""

    draft_arch: Optional[str] = None
    k: int = 4
    enabled: bool = False


# draft cache families the engine can roll back on rejection: dense and
# moe (positional KV rows: rewinding the write cursor IS the rollback) and
# pure-SSM (no positions; a small recurrent state snapshotted per draft
# step). Mixed families (hybrid) have neither property.
_DRAFT_POSITIONAL = ("dense", "moe")
_DRAFT_SNAPSHOT = ("ssm",)


def resolve_draft(spec: SpecConfig, *, vocab: Optional[int] = None,
                  arch_name: Optional[str] = None):
    """Resolve ``spec.draft_arch`` to the concrete draft ``ModelConfig``
    whose vocab matches the target's actual ``vocab`` (the full config
    first, then its reduced variant: a reduced target pairs with a reduced
    draft). Raises ``ValueError`` on a vocab mismatch or a draft family
    that cannot be rolled back (hybrid, encdec), with the JAX package's
    messages, and ``NotImplementedError`` for a draft arch not ported yet
    (the vlm)."""
    from ..configs import get_config

    name = spec.draft_arch or arch_name
    if name is None:
        raise ValueError(
            "SpecConfig.draft_arch is unset and the target arch is "
            "unknown; name a draft model from repro.configs.ARCHS")
    # self-draft against a reduced() target: the smoke variant is not a
    # registry entry of its own, so resolve through its base arch (the
    # vocab match below then picks the reduced candidate back out)
    if name.endswith("-smoke"):
        name = name[: -len("-smoke")]
    full = get_config(name)   # an arch not ported yet raises here
    cands = (full, full.reduced())
    dcfg = next((c for c in cands if vocab is None or c.vocab == vocab),
                None)
    if dcfg is None:
        raise ValueError(
            f"speculative draft {name!r} shares no vocabulary with the "
            f"target (target vocab {vocab}; draft full={full.vocab}, "
            f"reduced={full.reduced().vocab}) — verify compares token ids "
            f"directly, so draft and target need one tokenizer; pick a "
            f"same-vocab draft_arch or SpecConfig(draft_arch=None) for "
            f"self-draft")
    if dcfg.family not in _DRAFT_POSITIONAL + _DRAFT_SNAPSHOT:
        raise ValueError(
            f"speculative draft {name!r} (family {dcfg.family!r}) mixes "
            f"positional and recurrent cache state, which the engine "
            f"cannot roll back on rejection; supported draft families: "
            f"dense/moe (positional rewind) and ssm (state snapshot)")
    return dcfg


@dataclasses.dataclass(frozen=True, eq=False)
class ResolvedPlan:
    """Everything an engine needs, resolved and negotiated ONCE by
    :func:`validate`; engines consume only this, never the raw config.
    ``spec`` / ``draft_cfg``: the (normalized) SpecConfig and, when it is
    enabled, the vocab-matched draft ``ModelConfig`` (else ``None``)."""

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
    # the (normalized) ParallelConfig and its Mesh (None = single device)
    parallel: ParallelConfig = dataclasses.field(
        default_factory=ParallelConfig)
    mesh: Optional[Any] = None
    spec: SpecConfig = dataclasses.field(default_factory=SpecConfig)
    draft_cfg: Optional[Any] = None


def normalize_groups(cfg) -> None:
    """Shared ``EngineConfig``/``BatchConfig`` ``__post_init__`` normalizer:
    default the grouped sub-configs (``memory`` / ``attention`` /
    ``parallel`` / ``spec``) and coerce an ``attention`` string to
    ``AttentionConfig(impl=...)``."""
    cfg.memory = getattr(cfg, "memory", None) or MemoryConfig()
    a = getattr(cfg, "attention", None)
    cfg.attention = a if isinstance(a, AttentionConfig) else AttentionConfig(
        impl=a or "auto")
    cfg.parallel = getattr(cfg, "parallel", None) or ParallelConfig()
    cfg.spec = getattr(cfg, "spec", None) or SpecConfig()


def _memory_of(cfg) -> MemoryConfig:
    """``cfg.memory``, or a MemoryConfig from the flat ``prefix_cache`` /
    ``host_tier`` / ``skip_ahead_limit`` attributes of a duck-typed
    config."""
    m = getattr(cfg, "memory", None)
    if isinstance(m, MemoryConfig):
        return m
    sal = getattr(cfg, "skip_ahead_limit", None)
    return MemoryConfig(
        prefix_cache=bool(getattr(cfg, "prefix_cache", False) or False),
        host_tier=bool(getattr(cfg, "host_tier", False) or False),
        skip_ahead_limit=4 if sal is None else int(sal),
    )


def _not_ported(what: str):
    return NotImplementedError(f"not ported yet: {what}")


def validate(cfg, *, paged_capable: bool = True,
             n_heads: Optional[int] = None,
             n_kv_heads: Optional[int] = None,
             arch_name: Optional[str] = None,
             vocab: Optional[int] = None) -> ResolvedPlan:
    """THE config -> plan entry point: one call, one loud error surface.
    ``cfg`` is duck-typed over ``EngineConfig`` / ``BatchConfig``; the head
    counts come from the engine that owns the model. Raises ``ValueError``
    on an incompatible combination and ``NotImplementedError`` on a feature
    this package does not have yet.

    The mesh (``cfg.parallel``) as in the JAX package: with the lanes
    layout it is refused (TP shards the PAGED pool's head axis); with
    ``attention='fused'`` the ``model`` axis must divide Hq and Hkv (each
    shard's K2 launch reads whole GQA groups); and the mesh must find its
    devices (``ParallelConfig.build_mesh``). The host tier's check that
    every mesh device belongs to this process always passes here: a mesh is
    one process.

    Speculative decoding (``cfg.spec``) as in the JAX package: its verify
    IS a chunked step through ``decode_chunk_paged``, so it needs the paged
    layout, ``k >= 1`` and a draft resolved by :func:`resolve_draft`
    against the target's ``vocab``."""
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
    chunked = bool(getattr(cfg, "chunked", False))
    if chunked and getattr(cfg, "chunk_size", 1) < 1:
        raise ValueError("chunk_size must be >= 1")
    memory = _memory_of(cfg)
    parallel = getattr(cfg, "parallel", None) or ParallelConfig()
    if parallel.enabled and layout != "paged":
        raise ValueError(
            f"mesh-sharded serving (ParallelConfig mesh "
            f"{parallel.mesh_shape}x{parallel.axis_names}) shards the "
            f"paged pool's head axis, but kv_layout={layout!r} serves the "
            f"model's own cache lanes; use kv_layout='paged' (dense "
            f"non-SWA DecoderLM family) or the default single-device "
            f"ParallelConfig()")
    negotiate_memory(layout=layout, chunked=chunked,
                     prefix_cache=memory.prefix_cache,
                     host_tier=memory.host_tier)
    attn_cfg = getattr(cfg, "attention", None)
    if not isinstance(attn_cfg, AttentionConfig):
        attn_cfg = AttentionConfig(impl=attn_cfg or "auto")
    if attn_cfg.drain_kernel is not None:
        raise _not_ported(
            "AttentionConfig.drain_kernel (the drain runs the kernel on a "
            "CUDA tensor and its plain version on a CPU tensor)")
    attention = resolve_attention(attn_cfg.impl, layout=layout,
                                  arch_paged_capable=paged_capable,
                                  device=device)
    tp = parallel.tp
    if attention == ATTN_FUSED and tp > 1 and (
            n_heads is not None and n_kv_heads is not None) and (
            n_heads % tp or n_kv_heads % tp):
        raise ValueError(
            f"attention='fused' under a model-axis of {tp} needs whole "
            f"head groups per shard, but {arch_name or 'this model'} has "
            f"Hq={n_heads}, Hkv={n_kv_heads} (both must divide by {tp}); "
            f"use attention='reference', a divisible mesh, or a "
            f"divisible-head arch")
    # raises when the devices are missing; one process holds every device
    # of the mesh, so the host tier's gather is always local
    mesh = parallel.build_mesh(device=device)

    # function-level import: core must not import serve at module scope
    from ..serve.traffic.sched import build_sched

    sched = build_sched(getattr(cfg, "sched", None) or "fifo")
    # preemption parks the victim's KV in the host tier (which itself
    # implies the paged layout): without it the combination is refused here
    if sched.preempts and not memory.host_tier:
        raise ValueError(
            f"sched={sched.name!r} preempts running slots by parking "
            f"their KV in the host tier, but memory.host_tier is off; "
            f"use memory=MemoryConfig(host_tier=True) (paged layout) or "
            f"a non-preempting sched")

    # speculative decoding (the third execution path): the k-token verify
    # IS a chunked step through decode_chunk_paged, so spec needs the paged
    # layout (lanes has no chunk verifier), a proposal depth of at least
    # one, and a draft whose vocabulary matches the target's
    spec = getattr(cfg, "spec", None) or SpecConfig()
    draft_cfg = None
    if spec.enabled:
        if layout != "paged":
            raise ValueError(
                f"speculative decoding verifies k tokens through "
                f"decode_chunk_paged over the paged pool, but "
                f"kv_layout={layout!r} has no chunk verifier; use the "
                f"paged layout (dense non-SWA DecoderLM family) or "
                f"SpecConfig(enabled=False)")
        if spec.k < 1:
            raise ValueError(
                f"SpecConfig.k must be >= 1 (k tokens proposed per "
                f"verify round), got {spec.k}")
        draft_cfg = resolve_draft(spec, vocab=vocab, arch_name=arch_name)

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
        hot_threshold=getattr(cfg, "hot_threshold", 4), layout=layout,
        chunked=chunked)
    return ResolvedPlan(
        layout=layout, attention=attention, path=path, decision=decision,
        sched=sched, memory=memory, device=device, n_blocks=n_blocks,
        max_pages=max_pages, n_regions=n_regions, parallel=parallel,
        mesh=mesh, spec=spec, draft_cfg=draft_cfg)


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
    "negotiate", "negotiate_memory", "resolve_attention", "resolve_device",
    "build_decision",
    "ParallelConfig", "MemoryConfig", "AttentionConfig", "ResolvedPlan",
    "SpecConfig", "resolve_draft", "validate", "normalize_groups",
]
