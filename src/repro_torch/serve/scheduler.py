"""Port of repro/serve/scheduler.py (blocking and chunked admission; paged
and lanes layouts; sampled and speculative decoding; admission policies and
preemption; the virtual-time hook).

Continuous-batching serve scheduler: a fixed array of serving SLOTS decodes
in lock-step, each slot at its own position in its own request, so the
DecisionModule sees an interleaved multi-tenant write stream. Two cache
layouts, as in the JAX package:

* ``paged`` (linear-addressed dense decoders): per-slot destination blocks
  in a SHARED physical pool, all three write paths;
* ``lanes`` (the sliding-window dense decoder; the MoE family, whose
  every layer dispatches its tokens to experts and drains them through K1
  in staged mode; the SSM and hybrid families, whose cache holds a
  recurrent state a slot; the encoder-decoder family, whose cache adds the
  cross K/V of ``n_audio_frames`` rows that admission writes once from the
  request's media): one cache lane per slot in every leaf of
  ``model.init_cache(n_slots, max_seq)`` (batch on axis 1; KV lanes
  ring-addressed under SWA, read by the ``flash_decode`` kernel), direct
  writes only. The monitor's region is ``slot * max_pages + pos //
  page_size`` (decode writes only land in the self-attention lanes).
* **Media**: a request's ``media`` (stub frontend embeddings) go to a
  model that takes them (``needs_media``), stacked per admission group;
  under ``chunked`` an encoder-decoder gets them on its first chunk only.
  A model that takes none ignores them, as in the JAX package.

* **SlotState**: per-slot phase / token / position / done-flag /
  remaining-budget / key chain / request-id / sampling parameters / stop
  table, fixed-shape tensors on the engine's device. Every decode step
  samples each slot under its own request's parameters
  (``models.sampling``); a request's key is ``fold_in(key(sample_seed),
  req_id)`` or ``key(seed)`` for an explicit seed, so its stream does not
  depend on its slot or on the admission order. Retirement is in-segment:
  a slot whose emitted token hits a stop token or whose budget is spent
  flips ``done`` and from the next step neither writes KV (its destination
  resolves to the sink) nor updates the monitor.
* **Segments**: where the JAX package jits a ``lax.scan``, a segment here is
  a Python loop of ``segment_len`` eager steps over preallocated device
  tensors with NO host read inside the loop and one readback at its end.
  The conditional drain never asks the host whether it is due (see
  ``kvcache.paged.maybe_drain``). The segment boundary forces a drain, so the
  host never frees a block with staged bytes in flight.
* **Mixed-phase segments** (``chunked=True``, paged layout): a request is
  admitted at once in PREFILL phase with its prompt in a device buffer and
  only the pages the next segment can touch. Each step every live slot
  processes a [chunk_size]-token slab through ``decode_chunk_paged``: a
  prefilling slot its next prompt chunk, a decoding slot its one token in
  column 0; a slot whose cursor crosses its prompt length flips to DECODE
  inside the segment and emits its first token, the prefill argmax. The
  step's writes go to the decision plane as ONE flattened batch of
  ``n_slots x chunk_size`` writes, prefill rows tagged ``PHASE_BULK`` (pinned
  to the offload path). Between segments ``_topup_blocks`` extends each
  live slot's pages; a slot it cannot cover stalls for one segment.
* **Admission**: between segments, on the host. The FIFO ``RequestQueue`` is
  scanned in submission order and a request that does not fit is skipped in
  favour of later ones that do (bounded by ``skip_ahead_limit``). Without
  ``chunked`` prompts are prefilled at admission, same-length prompts in one
  batched call; the rows land in the pool by a host-computed physical row
  list (paged), or the group's cache overwrites the slots' lanes wholesale,
  every leaf (lanes; with ``chunked`` its prompts are prefilled chunk by
  chunk through ``model.chunk_prefill``, the recurrent state carried from
  chunk to chunk).
* **KV writes** (paged): every decode-time write resolves through the page
  table to a physical pool row; direct writes scatter straight in, staged
  writes ride the per-slot ring overlay and drain in bulk through
  ``core.ring.scatter_rows_layers``. The monitor's region is the BLOCK id.
  (lanes): a retired slot's write goes to the drop row ``cache_len``; a
  recurrent state has no rows to drop (slot-private, overwritten at
  admission).
* **Prefix cache** (``MemoryConfig(prefix_cache=True)``, paged + chunked):
  between segments (after the boundary drain, so pool content is final)
  every fully written full prompt page is registered under its chained
  content hash; admission shares every leading registered page of a new
  prompt (refcount + 1, no prefill for those rows) and starts the chunk
  cursor past them. A fully cached prompt re-runs its last row for the
  first token's logits, so its last shared block is copied to a private
  one first (copy-on-write): no write ever lands in a shared or
  registered block.
* **Host tier** (``MemoryConfig(host_tier=True)``, paged): when the pool
  runs short, whole slots strictly younger than the requester (youngest
  first) are PARKED: their blocks unload to pinned host memory in one bulk
  copy per plane, their page-table rows clear and the slots stall; between
  segments parked slots page back in oldest first. The oldest live slot is
  never a victim, so it always makes progress.

* **Admission order** (``sched``): the policy permutes the scan order only
  (FIFO, priority, earliest deadline); skip-ahead counts the policy's head.
  ``sched/preempt`` also evicts the lowest-priority running slot for a
  strictly higher-priority waiting request: its blocks unload to the host
  store, its slot scalars and key are saved, its request goes back to the
  queue head, and it resumes verbatim into whichever slot is free.
* **Clock**: timestamps come off ``self.clock`` (wall ``perf_counter``).
  The loadtest harness installs a ``VirtualClock`` and a ``time_model``
  (segment telemetry -> seconds), and ``run_segment`` advances the clock
  by it before first tokens are stamped.

* **Mesh** (``parallel=ParallelConfig.tensor(tp)``, paged layout,
  DESIGN.md §9): the block pool and the staging ring split on the head axis
  across ``tp`` shards (``_make_cache``); the decision plane (page
  table, ring cursors, monitor, slot state, stats) stays whole on the lead
  device, where the segment-end readback reads it. Each drain is one K1
  launch per device (the K and V planes of every shard there), each fused
  read one K2 launch per device (its grid over the shards there); the
  parameters stay whole on the lead device, which runs the projections. The
  output is the unsharded engine's, bit for bit.

* **Speculative decoding** (``spec=SpecConfig(enabled=True, k=...)``, paged
  layout, DESIGN.md §11): once no slot prefills, a segment is
  ``segment_len`` draft-then-verify rounds. Each round the draft (the
  target itself for self-draft, else its own model: a dense or MoE
  ``DecoderLM`` or an SSM ``MambaLM``) runs ``k + 1`` decode steps on its
  own lanes cache, sampling ``k`` proposals off the slot's separate
  ``dkey`` chain; the target verifies ``[token,
  d_1..d_k]`` in ONE ``decode_chunk_paged(all_logits=True)`` step, whose
  rows go to the decision plane tagged ``PHASE_BULK`` (pinned to the
  offload path); ``spec_verify`` commits the accepted run plus one target
  token, cut at the budget and the first stop. Rejected rows are rolled
  back by cursor: the draft's and the pool's stale rows past ``pos`` are
  rewritten before any read; a recurrent (SSM) draft keeps one copy of its
  state a draft step and each slot takes back the one at its committed
  count (``PG.select_snapshot``). The draft cache is derived data:
  ``_sync_draft`` re-prefills a stale lane (after admission, a resume or
  a mixed segment) from the prompt and the committed tokens.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..core.paths import (_DRAFT_POSITIONAL, MemoryConfig,
                          normalize_groups, validate)
from ..core.types import (PHASE_BULK, PHASE_SCATTERED, SpecStats,
                          WriteBatch, make_write_batch, resolve_device)
from ..data.pipeline import RequestQueue
from ..kvcache import paged as PG
from ..models import prng
from ..models import sampling as SMP
from ..models.sampling import SamplingParams, SlotParams
from ..configs.base import DENSE
from ..models.model import needs_media
from ..models.transformer import DecoderLM, compute_dtype

PHASE_PREFILL = 0
PHASE_DECODE = 1


def paged_capable(model) -> bool:
    """Can this model serve from the paged pool? Linear-addressed dense
    ``DecoderLM`` only (an ``MoELM`` is a ``DecoderLM`` of the moe family,
    and ``MambaLM`` / ``ZambaLM`` are no ``DecoderLM``: lanes, as in the JAX
    package)."""
    return (isinstance(model, DecoderLM)
            and model.cfg.family == DENSE
            and not model.is_vlm
            and not model.cfg.sliding_window)


class SlotState(NamedTuple):
    """Fixed slot array: the whole scheduler state a segment carries.

    phase:     int[S]  PHASE_PREFILL (consuming prompt chunks) or
                       PHASE_DECODE; meaningful only while not done
    token:     int[S]  last emitted token (next decode step's input)
    pos:       int[S]  next logical row to write: the chunk cursor while
                       prefilling, the decode position afterwards
    done:      bool[S] retired (or never admitted)
    remaining: int[S]  tokens the slot may still emit
    key:       int[S, 2] per-slot threefry key data (uint32 values in
                       int64): split once per decode step in the sampling
                       modes, greedy slots included; prefill consumes none
    req_id:    int[S]  owning request id (-1 = empty)
    plen:      int[S]  prompt length
    temperature f32[S]; top_k int[S]; top_p f32[S];
    stop       int[S, MAX_STOP_TOKENS] stop-token table (-1 padded)
    dkey:      int[S, 2] the draft's proposal key chain (speculative
                       decoding): separate from ``key``, so the target
                       chain's splits never depend on how many proposals
                       the draft made; zeros when spec is off
    """

    phase: torch.Tensor
    token: torch.Tensor
    pos: torch.Tensor
    done: torch.Tensor
    remaining: torch.Tensor
    key: torch.Tensor
    req_id: torch.Tensor
    plen: torch.Tensor
    temperature: torch.Tensor
    top_k: torch.Tensor
    top_p: torch.Tensor
    stop: torch.Tensor
    dkey: torch.Tensor

    @property
    def sampling(self) -> SlotParams:
        return SlotParams(temperature=self.temperature, top_k=self.top_k,
                          top_p=self.top_p, stop=self.stop)


def make_slots(n_slots: int, device="cuda") -> SlotState:
    """Per-slot decode state, on the card unless ``device`` says otherwise."""
    device = resolve_device(device)
    sp = SMP.make_slot_params(n_slots, device)

    def ints(fill, *shape):
        return torch.full(shape or (n_slots,), fill, dtype=torch.int64,
                          device=device)

    return SlotState(
        phase=ints(PHASE_DECODE), token=ints(0), pos=ints(0),
        done=torch.ones((n_slots,), dtype=torch.bool, device=device),
        remaining=ints(0), key=ints(0, n_slots, 2), req_id=ints(-1),
        plen=ints(0), temperature=sp.temperature, top_k=sp.top_k,
        top_p=sp.top_p, stop=sp.stop, dkey=ints(0, n_slots, 2),
    )


@dataclasses.dataclass
class BatchConfig:
    """Continuous-batching engine configuration. ``max_seq`` bounds
    prompt_len + max_new per request; ``n_blocks = 0`` sizes the pool for
    zero contention. ``path``/``policy`` name a registered WritePath and
    RoutingPolicy; ``attention`` picks the paged read implementation
    (``auto`` | ``fused`` | ``reference``); ``chunked`` prefills in
    ``chunk_size``-token pieces (inside the segments on the paged layout,
    at admission on lanes); ``device`` is where the engine runs
    (``"cuda"`` raises on a machine without it). ``greedy``,
    ``default_params`` and ``sample_seed`` set the sampling defaults and the
    key chains; ``sched`` names an admission policy. ``parallel`` (a
    ``ParallelConfig``) and ``spec`` (a ``SpecConfig``) are the JAX
    package's groups."""

    max_seq: int
    n_slots: int = 8
    segment_len: int = 16
    write_mode: str = "direct"
    page_size: int = 8
    n_blocks: int = 0
    ring_size: int = 8
    hot_threshold: int = 4
    greedy: bool = True
    eos_id: Optional[int] = None
    attention: Any = None        # AttentionConfig (str = impl shorthand)
    kv_layout: str = "auto"
    sample_seed: int = 0
    chunked: bool = False
    chunk_size: int = 8
    path: Optional[str] = None
    policy: Optional[str] = None
    sched: str = "fifo"
    default_params: Optional[SamplingParams] = None
    memory: Optional[MemoryConfig] = None
    parallel: Any = None
    spec: Any = None
    device: str = "cuda"

    def __post_init__(self):
        normalize_groups(self)


class BatchedServeEngine:
    """Slot-based continuous-batching serving engine; build it through
    ``repro_torch.serve.Engine.from_config``."""

    def __init__(self, model: DecoderLM, cfg: BatchConfig, *,
                 _internal: bool = False):
        if not _internal:
            raise TypeError(
                "build engines through "
                "repro_torch.serve.Engine.from_config(...)")
        self.model = model
        self.cfg = cfg
        plan = validate(cfg, paged_capable=paged_capable(model),
                        n_heads=model.cfg.n_heads,
                        n_kv_heads=model.cfg.n_kv_heads,
                        arch_name=model.cfg.name, vocab=model.cfg.vocab)
        self.plan = plan
        self.device = plan.device
        self.mesh = plan.mesh
        if model.device.type != self.device.type:
            raise ValueError(
                f"model lives on {model.device} but the engine was asked "
                f"for {self.device}")
        if self.device.type == "cuda":
            # fp32 matrix products stay full fp32 (the default, stated)
            torch.backends.cuda.matmul.allow_tf32 = False
        self.layout = plan.layout
        # the encoder-decoder family takes each request's media at admission
        self._takes_media = needs_media(model.cfg)
        self._prefix_cache = plan.memory.prefix_cache
        self._host_tier = plan.memory.host_tier
        self._skip_limit = plan.memory.skip_ahead_limit
        self._sched = plan.sched
        self.max_pages = plan.max_pages
        self.n_blocks = plan.n_blocks
        self.path, self.decision = plan.path, plan.decision
        self.uses_ring = self.path.uses_ring
        self.attention = plan.attention
        # in-segment chunked prefill needs the paged pool's row addressing;
        # lanes prefills chunk by chunk at admission instead
        self._in_scan_prefill = cfg.chunked and self.layout == "paged"
        # the engine clock: every scheduler timestamp comes off it. The
        # loadtest harness swaps in a VirtualClock and sets ``time_model``
        # (segment telemetry -> seconds), so run_segment advances virtual
        # time instead of letting wall time pass
        self.clock: Callable[[], float] = time.perf_counter
        self.time_model: Optional[Callable[[dict], float]] = None
        self.stats = {
            "direct_writes": 0, "staged_writes": 0, "drains": 0,
            "prefill_writes": 0, "segments": 0, "admitted": 0, "retired": 0,
            "prefix_hit_rows": 0, "cow_copies": 0,
            "host_unloads": 0, "host_pageins": 0,
            "preemptions": 0, "preempt_resumes": 0,
            # speculative decoding (SpecStats): committed / rounds is the
            # committed tokens per target verify step
            "spec_proposed": 0, "spec_accepted": 0,
            "spec_committed": 0, "spec_rounds": 0,
        }
        # speculative decoding: the draft proposes k tokens per live slot
        # inside the spec segment; the target verifies them in one step
        self.spec = plan.spec
        self._spec_enabled = plan.spec.enabled
        self.draft_model = None
        self.draft_cache = None
        self._draft_positional = True
        self._draft_pos: List[int] = [-1] * cfg.n_slots
        if self._spec_enabled:
            self._init_draft(plan.draft_cfg)
        self.reset()

    def _init_draft(self, dcfg) -> None:
        """The draft side of the speculative path. Self-draft
        (``SpecConfig(draft_arch=None)``, or a draft config equal to the
        target's) shares the target's modules and parameters, also for a
        target config the registry does not hold (a cut depth or dtype),
        where the JAX engine would build the registry's config with fresh
        weights instead; another arch (dense, MoE or SSM) gets its own
        model on the engine's lead device, weights from seed 17 (the JAX
        engine draws its draft's from ``jax.random.key(17)``; to compare
        the two, load the same weights with
        ``checkpoint.params_from_numpy``). Its cache is a lanes cache
        (``init_cache``), made by ``reset``; under a mesh it stays whole on
        the lead device, as the parameters do. Positional drafts (dense,
        moe) roll back by cursor, recurrent ones (ssm) by state snapshots
        (``_draft_positional`` False)."""
        model = self.model
        if self.spec.draft_arch is None or dcfg == model.cfg:
            self.draft_model = model
        else:
            from ..models.model import build_model
            self.draft_model = build_model(dcfg, device=model.device).init(17)
        self._draft_positional = dcfg.family in _DRAFT_POSITIONAL

    def _make_cache(self):
        """The layout's device cache. Under ``self.mesh`` (the JAX engine's
        ``_shard_device_state``) the pool and ring are made split on the
        HEAD axis by ``serve_cache_shardings``, piece by piece on the mesh's
        devices; the page table and ring metadata stay whole on the lead
        device, so the host's decision plane is the one every shard follows
        and drains stay shard-local. The parameters stay whole on the lead
        device (the train stack's ``param_shardings`` is not ported)."""
        cfg, mcfg = self.cfg, self.model.cfg
        if self.layout == "lanes":
            return self.model.init_cache(cfg.n_slots, cfg.max_seq)
        return PG.make_paged_kv(
            mcfg.n_layers, self.n_blocks, cfg.page_size, cfg.n_slots,
            self.max_pages, mcfg.n_kv_heads, mcfg.resolved_head_dim,
            dtype=compute_dtype(mcfg),
            ring_size=cfg.ring_size if self.uses_ring else 0,
            device=self.device, mesh=self.mesh)

    def reset(self, keep_cache: bool = False) -> None:
        """Fresh serving state (cache, slots, pool, monitor, outputs).
        ``keep_cache=True`` keeps the pool and the device cache instead
        (every slot must already be retired): registered prefix blocks
        survive on the evictable list, so the next pass serves WARM."""
        cfg = self.cfg
        if keep_cache:
            if any(self._occupied):
                raise RuntimeError(
                    "reset(keep_cache=True) needs a drained engine "
                    "(live slots still hold pool blocks)")
        else:
            self.pool = (PG.BlockPool(self.n_blocks)
                         if self.layout == "paged" else None)
            self.cache = None  # release the old cache before allocating
            self.cache = self._make_cache()
        self.slots = make_slots(cfg.n_slots, self.device)
        # the device prompt buffer of in-segment chunked prefill
        self.prompts = (torch.zeros((cfg.n_slots, cfg.max_seq),
                                    dtype=torch.int64, device=self.device)
                        if self._in_scan_prefill else None)
        self.mon_state = self.decision.init_state(self.device)
        # constant tail of every step's WriteBatch (offset/size/hint/phase);
        # the mixed step's n_slots x chunk_size writes take offset/size/hint
        self._batch_tail = tuple(make_write_batch(
            torch.zeros((cfg.n_slots,), device=self.device))[1:])
        self._chunk_tail = tuple(make_write_batch(torch.zeros(
            (cfg.n_slots * cfg.chunk_size,), device=self.device))[1:4])
        # host-side shadows (device round-trips happen once per segment)
        self._occupied = [False] * cfg.n_slots
        self._slot_req: List[int] = [-1] * cfg.n_slots
        self._slot_plen: List[int] = [0] * cfg.n_slots
        self._slot_max_new: List[int] = [0] * cfg.n_slots
        self._slot_pages: List[int] = [0] * cfg.n_slots
        # admission seniority: top-up visits slots oldest first
        self._slot_seq: List[int] = [-1] * cfg.n_slots
        self._adm_seq = 0
        # prefix-cache bookkeeping (per-slot page hashes + registration
        # cursor) and the host tier's park state (parked slots' blocks live
        # in host memory, keyed by slot)
        self._slot_hashes: List[List[int]] = [[] for _ in range(cfg.n_slots)]
        self._slot_reg: List[int] = [0] * cfg.n_slots
        self._parked: List[bool] = [False] * cfg.n_slots
        self._host_store: Dict[int, tuple] = {}
        self._skip_rid = -1
        self._skip_count = 0
        self._base_key = prng.key(cfg.sample_seed, self.device)
        # preempt-and-requeue: the live requests (requeued verbatim on
        # preemption), each slot's priority, and each preempted request's
        # saved state (host KV, slot scalars, key) until it resumes
        self._requests: Dict[int, Any] = {}
        self._preempted: Dict[int, dict] = {}
        self._slot_priority: List[int] = [0] * cfg.n_slots
        self.outputs: Dict[int, List[int]] = {}
        self.ttft: Dict[int, float] = {}
        # per-request telemetry: resolved SamplingParams and write-path
        # counts [direct, staged, prefill] (the Completion payload)
        self.req_params: Dict[int, SamplingParams] = {}
        self.req_writes: Dict[int, np.ndarray] = {}
        self._t_serve0: Optional[float] = None
        self.req_arrival: Dict[int, float] = {}
        self.first_token_t: Dict[int, float] = {}
        if self._spec_enabled:
            # the draft's lanes: derived data, re-prefilled from the
            # committed tokens by ``_sync_draft``
            self.draft_cache = None
            self.draft_cache = self.draft_model.init_cache(cfg.n_slots,
                                                           cfg.max_seq)
            self._draft_pos = [-1] * cfg.n_slots
            # the verify rows' WriteBatch tail: every row PHASE_BULK
            n = cfg.n_slots * (self.spec.k + 1)
            self._verify_tail = tuple(make_write_batch(
                torch.zeros((n,), device=self.device),
                phase=torch.full((n,), PHASE_BULK, device=self.device))[1:])
        self.stats = {k: 0 for k in self.stats}

    # ------------------------------------------------------------------
    # the decode segment
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _decode_segment(self, enabled: torch.Tensor, mode: str):
        """``segment_len`` decode steps: every live slot samples one token
        per step. Nothing in here reads a device value on the host."""
        model, cfg, dev = self.model, self.cfg, self.device
        paged = self.layout == "paged"
        ring = paged and self.uses_ring
        ps, nb, mp = cfg.page_size, self.n_blocks, self.max_pages
        decision, attn = self.decision, self.attention
        cache, st, mon = self.cache, self.slots, self.mon_state
        t_len, s = cfg.segment_len, cfg.n_slots
        # page-table products are segment-invariant (allocation is
        # host-side, between segments): derive them once
        plan = PG.step_plan(cache) if paged else None
        lane_base = torch.arange(s, device=dev) * mp
        stats = torch.zeros((4,), dtype=torch.int64, device=dev)
        swrites = torch.zeros((s, 3), dtype=torch.int64, device=dev)
        emits = torch.full((t_len, s), -1, dtype=torch.int64, device=dev)
        acts = torch.zeros((t_len, s), dtype=torch.bool, device=dev)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        zeros_s = torch.zeros((s,), dtype=torch.int64, device=dev)
        for t in range(t_len):
            active = ~st.done & enabled
            live_pos = torch.where(active, st.pos, -1)
            if paged:
                dest = PG.logical_to_physical(cache, live_pos)
                region = torch.clamp(dest // ps, max=nb - 1)
            else:
                region = lane_base + torch.clamp(st.pos // ps, 0, mp - 1)
            unload, mon, _ = decision(
                mon, WriteBatch(region, *self._batch_tail), active=active)
            n_u = unload.sum()
            drained = zero
            if ring:
                cache, due = PG.maybe_drain(cache, incoming_pos=live_pos)
                drained = due.to(torch.int64)
                logits, cache = model.decode_step_paged(
                    cache, st.token, st.pos, active, unload_mask=unload,
                    attention=attn, plan=plan)
            elif paged:
                logits, cache = model.decode_step_paged(
                    cache, st.token, st.pos, active, attention=attn,
                    plan=plan)
            else:
                # retired slots never write: their rows go to the drop row
                logits, cache = model.decode_step(cache, st.token, st.pos,
                                                  write_mask=active)
            nxt, key = SMP.sample_tokens(logits, st.key, st.sampling,
                                         mode=mode)
            nxt = torch.where(active, nxt, st.token)
            act_i = active.to(torch.int64)
            remaining = st.remaining - act_i
            ended = (remaining <= 0) | SMP.hits_stop(nxt, st.stop)
            st = st._replace(token=nxt, pos=st.pos + act_i,
                             done=st.done | (active & ended),
                             remaining=remaining, key=key)
            stats += torch.stack([act_i.sum() - n_u, n_u, drained, zero])
            swrites += torch.stack(
                [(active & ~unload).to(torch.int64),
                 unload.to(torch.int64), zeros_s], dim=1)
            emits[t] = torch.where(active, nxt, -1)
            acts[t] = active
        if ring:
            # segment boundary: the host may retire slots and free their
            # blocks next; the ring must not hold entries that would later
            # drain into reallocated blocks
            cache = PG.drain_ring(cache)
        self.cache, self.slots, self.mon_state = cache, st, mon
        return stats, swrites, emits, acts

    @torch.no_grad()
    def _mixed_segment(self, enabled: torch.Tensor, mode: str):
        """``segment_len`` mixed-phase steps (chunked, paged layout): every
        live slot processes a [chunk_size]-token slab, the next prompt chunk
        (PREFILL) or its one decode token (DECODE, column 0), and a slot
        flips PREFILL -> DECODE inside the segment when its cursor crosses
        its prompt length, emitting the prefill argmax. Nothing in here
        reads a device value on the host."""
        model, cfg, dev = self.model, self.cfg, self.device
        ring = self.uses_ring
        ps, nb, c = cfg.page_size, self.n_blocks, cfg.chunk_size
        decision, attn = self.decision, self.attention
        cache, st, mon, prompts = (self.cache, self.slots, self.mon_state,
                                   self.prompts)
        t_len, s = cfg.segment_len, cfg.n_slots
        plan = PG.step_plan(cache)
        stats = torch.zeros((4,), dtype=torch.int64, device=dev)
        swrites = torch.zeros((s, 3), dtype=torch.int64, device=dev)
        emits = torch.full((t_len, s), -1, dtype=torch.int64, device=dev)
        ems = torch.zeros((t_len, s), dtype=torch.bool, device=dev)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        offs = torch.arange(c, device=dev)[None, :]
        for t in range(t_len):
            active = ~st.done & enabled
            is_pf = active & (st.phase == PHASE_PREFILL)
            dec = active & ~is_pf
            # the token slab: prefill slots read the prompt buffer at their
            # chunk cursor, decode slots put their token in column 0
            idx = (st.pos[:, None] + offs).clamp(0, prompts.shape[1] - 1)
            tokens = torch.where(
                is_pf[:, None], prompts.gather(1, idx),
                torch.where(offs == 0, st.token[:, None], 0))
            n_valid = torch.where(is_pf, (st.plen - st.pos).clamp(max=c),
                                  active.to(torch.int64))
            qvalid = offs < n_valid[:, None]
            # ONE flattened phase-tagged batch per step: bulk prefill rows
            # are pinned offload, decode rows keep the path's routing
            dest_all = PG.logical_to_physical_many(
                cache, torch.where(qvalid, st.pos[:, None] + offs, -1))
            region = torch.clamp(dest_all // ps, max=nb - 1)
            phase_tag = torch.where(is_pf[:, None] & qvalid, PHASE_BULK,
                                    PHASE_SCATTERED)
            unload_flat, mon, _ = decision(
                mon, WriteBatch(region.reshape(-1), *self._chunk_tail,
                                phase_tag.reshape(-1)),
                active=qvalid.reshape(-1))
            unload = unload_flat.view(s, c)[:, 0] & dec
            n_u = unload.sum()
            drained = zero
            if ring:
                cache, due = PG.maybe_drain(
                    cache, incoming_pos=torch.where(dec, st.pos, -1))
                drained = due.to(torch.int64)
                logits, cache = model.decode_chunk_paged(
                    cache, tokens, st.pos, n_valid, active,
                    unload_mask=unload, attention=attn, plan=plan)
            else:
                logits, cache = model.decode_chunk_paged(
                    cache, tokens, st.pos, n_valid, active, attention=attn,
                    plan=plan)
            finishing = is_pf & (st.pos + n_valid >= st.plen)
            emitting = dec | finishing
            # the first token after the prompt is the prefill ARGMAX, as the
            # blocking engine's admission-time t0; prefill steps consume no
            # sampler key
            t0 = torch.argmax(logits, dim=-1)
            sampled, new_key = SMP.sample_tokens(logits, st.key, st.sampling,
                                                 mode=mode)
            nxt = torch.where(emitting, torch.where(dec, sampled, t0),
                              st.token)
            key = torch.where(dec[:, None], new_key, st.key)
            emit_i = emitting.to(torch.int64)
            remaining = st.remaining - emit_i
            ended = (remaining <= 0) | SMP.hits_stop(nxt, st.stop)
            st = st._replace(
                phase=torch.where(finishing, PHASE_DECODE, st.phase),
                token=nxt, pos=st.pos + n_valid,
                done=st.done | (emitting & ended),
                remaining=remaining, key=key)
            n_pf = (qvalid & is_pf[:, None]).sum()
            stats += torch.stack([dec.sum() - n_u, n_u, drained, n_pf])
            swrites += torch.stack(
                [(dec & ~unload).to(torch.int64), unload.to(torch.int64),
                 torch.where(is_pf, n_valid, 0)], dim=1)
            emits[t] = torch.where(emitting, nxt, -1)
            ems[t] = emitting
        if ring:
            # segment boundary: drain before the host frees or tops up
            # blocks (see ``_decode_segment``)
            cache = PG.drain_ring(cache)
        self.cache, self.slots, self.mon_state = cache, st, mon
        return stats, swrites, emits, ems

    @torch.no_grad()
    def _spec_segment(self, enabled: torch.Tensor, mode: str):
        """``segment_len`` speculative rounds (every live slot in DECODE
        phase, its draft lane in sync with ``pos``). A round: ``k + 1``
        draft decode steps on the dense draft lanes (``k`` proposals off
        ``dkey``, and one catch-up step so the draft's cache covers a fully
        accepted round and its bonus token), then ONE target verify of
        ``[token, d_1..d_k]`` through ``decode_chunk_paged(all_logits=
        True)``, capped at the slot's remaining budget (its rows are the
        allocated footprint, as in the other segments). The verify rows go
        to the decision plane as one flattened ``PHASE_BULK`` batch (pinned
        to the offload path, heating the monitor); rows past a slot's cap
        resolve to the sink. ``spec_verify`` accepts the agreeing prefix
        and commits it plus the target's own token; the commit is cut at
        the budget and after the first stop token. Retired and stalled
        slots write neither the draft lanes (their rows go to the drop row)
        nor the pool. Rejected rows need no undo: the next round rewrites
        them before any read. A recurrent draft's state advances in every
        slot, so it keeps a copy after each draft step and every slot takes
        back the one at its committed count (the round's first for a slot
        that was not active). Nothing in here reads a device value on the
        host. Returns the segment's stats, ``SpecStats``, per-slot writes,
        and the emissions ``[T, S, k + 1]`` with their mask."""
        model, cfg, dev = self.model, self.cfg, self.device
        k, dmodel = self.spec.k, self.draft_model
        positional = self._draft_positional
        ps, nb = cfg.page_size, self.n_blocks
        decision, attn = self.decision, self.attention
        cache, dcache, st, mon = (self.cache, self.draft_cache, self.slots,
                                  self.mon_state)
        t_len, s = cfg.segment_len, cfg.n_slots
        plan = PG.step_plan(cache)
        stats = torch.zeros((4,), dtype=torch.int64, device=dev)
        sst = SpecStats.zero(dev)
        swrites = torch.zeros((s, 3), dtype=torch.int64, device=dev)
        emits = torch.full((t_len, s, k + 1), -1, dtype=torch.int64,
                           device=dev)
        ems = torch.zeros((t_len, s, k + 1), dtype=torch.bool, device=dev)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        zeros_s = torch.zeros((s,), dtype=torch.int64, device=dev)
        offs = torch.arange(k + 1, device=dev)[None, :]
        for t in range(t_len):
            active = ~st.done & enabled
            # draft: k proposals, then the catch-up step
            d_tok, dkey = st.token, st.dkey
            d_toks, d_logits = [], []
            snaps = None if positional else [PG.snapshot(dcache)]
            for j in range(k + 1):
                dl, dcache = dmodel.decode_step(dcache, d_tok, st.pos + j,
                                                write_mask=active)
                if j < k:
                    d_tok, dkey = SMP.sample_tokens(dl, dkey, st.sampling,
                                                    mode=mode)
                    d_toks.append(d_tok)
                    d_logits.append(dl)
                if snaps is not None:
                    snaps.append(PG.snapshot(dcache))
            d_tokens = torch.stack(d_toks, dim=1)          # [S, k]
            d_log = torch.stack(d_logits, dim=1)           # [S, k, V]
            # verify: ONE chunked target step over [t_cur, d_1..d_k]
            chunk = torch.cat([st.token[:, None], d_tokens], dim=1)
            n_valid = torch.where(active, st.remaining.clamp(max=k + 1), 0)
            qvalid = offs < n_valid[:, None]
            dest = PG.logical_to_physical_many(
                cache, torch.where(qvalid, st.pos[:, None] + offs, -1))
            region = torch.clamp(dest // ps, max=nb - 1)
            _, mon, _ = decision(
                mon, WriteBatch(region.reshape(-1), *self._verify_tail),
                active=qvalid.reshape(-1))
            t_logits, cache = model.decode_chunk_paged(
                cache, chunk, st.pos, n_valid, active, attention=attn,
                plan=plan, all_logits=True)
            commit, n_commit, n_acc, key = SMP.spec_verify(
                t_logits, d_tokens, d_log, st.key, st.sampling, mode=mode)
            n_commit = torch.where(active, n_commit, 0)
            # commit: cut at the budget and after the first stop token (the
            # stop itself is emitted, as in the other segments)
            is_stop = (commit[:, :, None] == st.stop[:, None, :]).any(-1)
            stop_i = is_stop.to(torch.int64)
            before = torch.cumsum(stop_i, dim=1) - stop_i
            emit = ((offs < n_commit[:, None]) & (before == 0)
                    & (offs < st.remaining[:, None]) & active[:, None])
            n_emit = emit.sum(dim=1)
            remaining = st.remaining - n_emit
            ended = (remaining <= 0) | (emit & is_stop).any(dim=1)
            last = commit.gather(1, (n_emit - 1).clamp(min=0)[:, None])[:, 0]
            if snaps is not None:
                # the recurrent draft's rollback: each slot's state after
                # its round's first n_emit inputs
                dcache = PG.select_snapshot(PG.snapshot_stack(snaps), n_emit)
                del snaps
            st = st._replace(
                token=torch.where(active & (n_emit > 0), last, st.token),
                pos=st.pos + n_emit, done=st.done | (active & ended),
                remaining=remaining, key=key, dkey=dkey)
            n_active = active.sum()
            stats += torch.stack([n_valid.sum(), zero, zero, zero])
            sst = SpecStats(
                sst.n_proposed + k * n_active,
                sst.n_accepted + torch.minimum(
                    torch.where(active, n_acc, 0), n_emit).sum(),
                sst.n_committed + n_emit.sum(), sst.n_rounds + n_active)
            swrites += torch.stack([n_valid, zeros_s, zeros_s], dim=1)
            emits[t] = torch.where(emit, commit, -1)
            ems[t] = emit
        if self.uses_ring:
            # segment boundary: the verify rows went direct, but the ring
            # is drained before the host frees or tops up blocks all the
            # same (see ``_decode_segment``)
            cache = PG.drain_ring(cache)
        self.cache, self.draft_cache = cache, dcache
        self.slots, self.mon_state = st, mon
        return stats, torch.stack(list(sst)), swrites, emits, ems

    # ------------------------------------------------------------------
    # admission / retirement / allocation (host, between segments)
    # ------------------------------------------------------------------
    def _pages_needed(self, plen: int, max_new: int) -> int:
        # decode writes rows plen .. plen+max_new-2 (the final emitted
        # token is never consumed, so its KV is never written)
        return max(1, -(-(plen + max_new - 1) // self.cfg.page_size))

    def _segment_cover_pages(self, pos: int, prefilling: bool, plen: int,
                             max_new: int) -> int:
        """Pages covering the worst-case rows the NEXT segment can write
        for a slot at ``pos``, shared by admission and the between-segment
        top-up: a prefilling slot advances at most ``segment_len *
        chunk_size`` rows, a decoding one ``segment_len`` (times ``k + 1``
        under speculative decoding: a round commits up to ``k + 1`` rows),
        both capped by the footprint ``plen + max_new - 1``."""
        cfg = self.cfg
        cap = plen + max_new - 1
        dec_rows = self.spec.k + 1 if self._spec_enabled else 1
        adv = cfg.segment_len * (cfg.chunk_size if prefilling else dec_rows)
        rows = min(pos + adv, max(cap, plen))
        return max(1, -(-rows // cfg.page_size))

    def _resolve_params(self, req) -> SamplingParams:
        """The request's effective SamplingParams: request > engine default
        > the ``greedy`` flag (for an unset temperature)."""
        return SMP.resolve(req.params, self.cfg.default_params,
                           self.cfg.greedy)

    def _admit_keys(self, reqs: List[Any], plist) -> torch.Tensor:
        """Each request's key data ``[g, 2]``: ``fold_in(base, req_id)``, or
        ``derive_key`` for an explicit seed. One vectorised fold for the
        group; seeded requests (the rare case) one by one."""
        keys = prng.fold_in(self._base_key[None, :], torch.as_tensor(
            [r.req_id for r in reqs], device=self.device))
        for i, p in enumerate(plist):
            if p.seed is not None:
                keys[i] = SMP.derive_key(self._base_key, 0, p.seed)
        return keys

    def _admit_dkeys(self, reqs: List[Any]) -> torch.Tensor:
        """Each request's draft-proposal key data ``[g, 2]``: the base key
        folded with a spec salt, then the request id, a chain of its own
        (zeros when spec is off)."""
        if not self._spec_enabled:
            return torch.zeros((len(reqs), 2), dtype=torch.int64,
                               device=self.device)
        dbase = prng.fold_in(self._base_key, 0x5BEC)
        return prng.fold_in(dbase[None, :], torch.as_tensor(
            [r.req_id for r in reqs], device=self.device))

    def _now(self) -> float:
        return self.clock()

    def _record_first_tokens(self, rids) -> None:
        now = self._now()
        if self._t_serve0 is None:
            self._t_serve0 = now
        for rid in rids:
            self.ttft.setdefault(rid, now - self._t_serve0)
            self.first_token_t.setdefault(rid, now)

    def _admission_plan(self, slot: int, req) -> Optional[dict]:
        """Reserve ``req``'s first blocks for ``slot``: the one place
        admission touches the pool. The lanes layout has no pool: a free
        slot is the whole footprint.

        Blocking: the whole footprint, fresh. Chunked: the pages of the
        first segment's rows (``_topup_blocks`` adds the rest); with the
        prefix cache, first walk the prompt's chained page hashes and SHARE
        every leading registered block (no prefill for those rows). A fully
        cached prompt still re-runs its LAST row (its logits give the first
        token), which would write into the last shared block: that block is
        copied to a private one here, before any write can reach it. On a
        shortfall every reservation is rolled back and None returned (the
        request keeps its queue position)."""
        cfg = self.cfg
        if self.pool is None:
            return {"blocks": None, "cached_rows": 0, "hashes": [],
                    "n_shared": 0}
        if not self._in_scan_prefill:
            blocks = self._alloc_reclaiming(
                slot, self._pages_needed(req.prompt_len, req.max_new), -1)
            if blocks is None:
                return None
            return {"blocks": blocks, "cached_rows": 0, "hashes": [],
                    "n_shared": 0}
        plen = req.prompt_len
        shared: List[int] = []
        hashes: List[int] = []
        if self._prefix_cache:
            hashes = PG.prefix_page_hashes(req.prompt, cfg.page_size)
            for h in hashes:
                b = self.pool.lookup(h)
                if b is None:
                    break
                shared.append(b)
        cached_rows = len(shared) * cfg.page_size
        cow_src = None
        if shared and cached_rows >= plen:
            cached_rows = plen - 1
            cow_src = shared[-1]
        first = self._segment_cover_pages(cached_rows, True, plen,
                                          req.max_new)
        blocks = list(shared)
        for b in shared:
            self.pool.share(slot, b)

        def rollback():
            for b in reversed(blocks):
                self.pool.release_block(slot, b)
            return None

        if cow_src is not None:
            new_b = self.pool.cow(slot, cow_src)
            if new_b is None:
                return rollback()
            PG.copy_block(self.cache, cow_src, new_b)
            blocks[-1] = new_b
            self.stats["cow_copies"] += 1
        fresh_n = first - len(shared)
        if fresh_n > 0:
            got = self._alloc_reclaiming(slot, fresh_n, -1)
            if got is None:
                return rollback()
            blocks.extend(int(x) for x in got)
        self.stats["prefix_hit_rows"] += cached_rows
        return {"blocks": np.asarray(blocks, np.int32),
                "cached_rows": cached_rows, "hashes": hashes,
                "n_shared": len(shared)}

    def _chunk_prefill_host(self, prompts: torch.Tensor, max_seq: int,
                            **media):
        """Whole-prompt prefill in ``chunk_size``-token pieces through
        ``model.chunk_prefill`` (the lanes layout under ``chunked``). An
        encoder-decoder (a model with ``encode``) is given the media on the
        FIRST chunk only: the encoder runs once an admission group and later
        chunks read its cross K/V from the cache (the JAX engine's
        ``media_once``); a model that reads media in every chunk (the VLM's
        gated cross layers) would be given them on each."""
        g, plen = prompts.shape
        cache = self.model.init_cache(g, max_seq)
        media_once = hasattr(self.model, "encode")
        logits = None
        for s0 in range(0, plen, self.cfg.chunk_size):
            kw = {} if (media_once and s0 > 0) else media
            logits, cache = self.model.chunk_prefill(
                cache, prompts[:, s0:s0 + self.cfg.chunk_size], s0, **kw)
        return logits, cache

    def _set_slots(self, slots: List[int], reqs: List[Any], plist, *,
                   phase: int, token, pos, done, remaining) -> None:
        """One slot-state update and the host shadows of an admitted group
        (``token`` / ``pos`` / ``done`` / ``remaining`` per request)."""
        cfg, dev = self.cfg, self.device
        g = len(reqs)
        slot_arr = torch.as_tensor(slots, device=dev).long()

        def put(old, values, dtype=None):
            new = old.clone()
            new[slot_arr] = torch.as_tensor(
                values, device=dev).to(dtype or old.dtype)
            return new

        st = self.slots
        self.slots = st._replace(
            phase=put(st.phase, np.full((g,), phase)),
            token=put(st.token, token),
            pos=put(st.pos, pos),
            done=put(st.done, done),
            remaining=put(st.remaining, remaining),
            req_id=put(st.req_id, np.asarray([r.req_id for r in reqs])),
            plen=put(st.plen, np.asarray([r.prompt_len for r in reqs])),
            key=put(st.key, self._admit_keys(reqs, plist)),
            dkey=put(st.dkey, self._admit_dkeys(reqs)),
            temperature=put(st.temperature,
                            np.asarray([p.temperature for p in plist],
                                       np.float32)),
            top_k=put(st.top_k, np.asarray([p.top_k for p in plist])),
            top_p=put(st.top_p,
                      np.asarray([p.top_p for p in plist], np.float32)),
            stop=put(st.stop, np.asarray(
                [SMP.stop_table(p, cfg.eos_id) for p in plist], np.int64)),
        )
        for slot, req, p in zip(slots, reqs, plist):
            self._occupied[slot] = True
            self._slot_req[slot] = req.req_id
            self._slot_plen[slot] = req.prompt_len
            self._slot_max_new[slot] = p.max_tokens
            self._slot_seq[slot] = self._adm_seq
            self._adm_seq += 1
            self._slot_priority[slot] = req.priority
            self._requests[req.req_id] = req
            self.req_arrival[req.req_id] = req.arrival_s
            self.req_params[req.req_id] = p
            self._draft_pos[slot] = -1   # the draft lane is stale
        self.stats["admitted"] += g

    @torch.no_grad()
    def _admit_chunked(self, slots: List[int], reqs: List[Any],
                       plans: List[dict]) -> None:
        """Chunked (paged) admission: NO prefill. The prompts go to the
        device buffer, the page table to the first segment's blocks (shared
        prefix blocks first, in page order), and the slots to the segments
        in PREFILL phase with the cursor past the cached rows."""
        cfg, dev = self.cfg, self.device
        g = len(reqs)
        slot_arr = torch.as_tensor(slots, device=dev).long()
        padded = np.zeros((g, cfg.max_seq), np.int64)
        table = np.full((g, self.max_pages), -1, np.int64)
        for i, (r, plan) in enumerate(zip(reqs, plans)):
            padded[i, : r.prompt_len] = r.prompt
            table[i, : len(plan["blocks"])] = plan["blocks"]
        self.prompts[slot_arr] = torch.as_tensor(padded, device=dev)
        self.cache["page_table"][slot_arr] = torch.as_tensor(table,
                                                             device=dev)
        plist = [self._resolve_params(r) for r in reqs]
        self._set_slots(
            slots, reqs, plist, phase=PHASE_PREFILL, token=np.zeros((g,)),
            pos=np.asarray([p["cached_rows"] for p in plans]),
            done=np.zeros((g,), bool),
            remaining=np.asarray([p.max_tokens for p in plist]))
        for slot, req, plan in zip(slots, reqs, plans):
            self._slot_pages[slot] = len(plan["blocks"])
            self._slot_hashes[slot] = plan["hashes"]
            self._slot_reg[slot] = plan["n_shared"]
            self.outputs[req.req_id] = []
            self.req_writes[req.req_id] = np.zeros((3,), np.int64)

    # -- host tier: park (device -> host unload) / unpark (page back in) --

    def _check_drained(self, victim: int, what: str) -> None:
        """A slot's blocks move to the host only after the boundary drain:
        no staged row may still be in the ring."""
        cache = self.cache
        if PG.has_ring(cache) and bool((cache["ring_pos"] >= 0).any()):
            raise RuntimeError(
                f"host tier: slot {victim} {what} with staged rows still in "
                f"the ring (the boundary drain must run first)")

    def _park(self, victim: int) -> None:
        """Unload ALL of ``victim``'s blocks to the host store and stall the
        slot: one bulk device -> host copy per plane, page-table row
        cleared, pool references dropped. Shared and registered blocks are
        copied, not stolen: other holders keep them, and the restore builds
        private replacements from the host copy. Runs between segments,
        after the boundary drain: no staged row may be in flight."""
        cache = self.cache
        self._check_drained(victim, "parked")
        blocks = list(self.pool.held(victim))
        n = self._slot_pages[victim]
        host_k, host_v = PG.unload_blocks(cache, blocks)
        self._host_store[victim] = (n, host_k, host_v)
        # a cleared row reads block 0 through ``kernel_blocks``: the slot is
        # also disabled until it pages back in (``_topup_blocks``)
        cache["page_table"][victim] = -1
        self.pool.free_slot(victim)
        self._slot_pages[victim] = 0
        self._parked[victim] = True
        self.stats["host_unloads"] += len(blocks)

    def _unpark(self, s: int) -> bool:
        """Page a parked slot back in: fresh blocks, one bulk host -> device
        copy per plane, page table repointed. False when the pool (even
        after parking strictly younger slots) can't cover it."""
        n, host_k, host_v = self._host_store[s]
        got = self._alloc_reclaiming(s, n, self._slot_seq[s])
        if got is None:
            return False
        PG.load_blocks(self.cache, got, host_k, host_v)
        self.cache["page_table"][s, :n] = torch.as_tensor(
            got, device=self.device).long()
        self._slot_pages[s] = n
        del self._host_store[s]
        self._parked[s] = False
        self.stats["host_pageins"] += n
        return True

    def _reclaim(self, need: int, requester_seq: int) -> bool:
        """Make >= ``need`` blocks available by parking live slots STRICTLY
        YOUNGER than ``requester_seq``, youngest first. The seniority order
        prevents livelock: the oldest live slot is never a victim, so it
        always makes progress, finishes, and frees its blocks for everyone
        behind it. ``requester_seq=-1`` (admission) may park any live
        slot."""
        if not self._host_tier:
            return False
        done = self.done_flags()
        victims = [s for s in range(self.cfg.n_slots)
                   if self._occupied[s] and not bool(done[s])
                   and not self._parked[s]
                   and self._slot_seq[s] > requester_seq]
        victims.sort(key=lambda s: -self._slot_seq[s])  # youngest first
        for v in victims:
            if self.pool.n_available >= need:
                break
            self._park(v)
        return self.pool.n_available >= need

    def _alloc_reclaiming(self, slot: int, n: int,
                          requester_seq: int) -> Optional[np.ndarray]:
        """``pool.alloc`` with the host-tier fallback: on failure, park
        younger slots until the request fits (or no victim is left)."""
        got = self.pool.alloc(slot, n)
        if got is not None or not self._host_tier:
            return got
        if self._reclaim(n, requester_seq):
            return self.pool.alloc(slot, n)
        return None

    def _register_pages(self, s: int, pos_s: int) -> None:
        """Publish ``s``'s fully written full-prompt pages under their
        content hashes (between segments: the ring is drained, so pool
        content is final). First registrant wins; the cursor is monotone,
        so each page registers at most once."""
        ps = self.cfg.page_size
        limit = min(len(self._slot_hashes[s]), self._slot_plen[s] // ps)
        reach = min(min(pos_s, self._slot_plen[s]) // ps, limit)
        if reach <= self._slot_reg[s]:
            return
        held = self.pool.held(s)
        for p in range(self._slot_reg[s], reach):
            self.pool.register(s, held[p], self._slot_hashes[s][p])
        self._slot_reg[s] = reach

    def _topup_blocks(self) -> np.ndarray:
        """The between-segment memory manager: page parked slots back in,
        extend live chunked slots' page tables to cover the rows the NEXT
        segment can write, and register finished prefix pages. Slots are
        visited oldest first, so host-tier reclaim composes with top-up
        without livelock. Returns the enabled mask: a slot whose blocks
        can't be covered (parked or top-up-starved) stalls for one
        segment."""
        cfg = self.cfg
        enabled = np.ones((cfg.n_slots,), bool)
        if not self._in_scan_prefill and not self._host_tier:
            return enabled
        pos = self.slots.pos.cpu().numpy()
        phase = self.slots.phase.cpu().numpy()
        done = self.done_flags()
        live = [s for s in range(cfg.n_slots)
                if self._occupied[s] and not bool(done[s])]
        live.sort(key=lambda s: self._slot_seq[s])  # oldest first
        for s in live:
            if self._parked[s]:
                if not self._unpark(s):
                    enabled[s] = False
                    continue
                # fall through: a restored chunked slot still needs its
                # page table extended for the rows the NEXT segment writes
            if not self._in_scan_prefill:
                continue
            if self._prefix_cache:
                self._register_pages(s, int(pos[s]))
            want = self._segment_cover_pages(
                int(pos[s]), phase[s] == PHASE_PREFILL, self._slot_plen[s],
                self._slot_max_new[s])
            have = self._slot_pages[s]
            if want > have:
                got = self._alloc_reclaiming(s, want - have,
                                             self._slot_seq[s])
                if got is None:
                    enabled[s] = False
                    continue
                self.cache["page_table"][s, have:want] = torch.as_tensor(
                    got, device=self.device).long()
                self._slot_pages[s] = want
        for s in live:
            # an older slot's reclaim may have parked a slot this loop
            # already enabled: parked slots never run
            if self._parked[s]:
                enabled[s] = False
        return enabled

    @torch.no_grad()
    def _admit_group(self, slots: List[int], reqs: List[Any],
                     plans: List[dict]) -> None:
        """Admit a group of same-prompt-length requests with ONE batched
        prefill + ONE insert + ONE slot-state update."""
        cfg, dev = self.cfg, self.device
        blocks = [p["blocks"] for p in plans]
        g, plen = len(reqs), reqs[0].prompt_len
        ps = cfg.page_size
        prompts = torch.as_tensor(np.stack([r.prompt for r in reqs]),
                                  device=dev).long()
        slot_arr = torch.as_tensor(slots, device=dev).long()
        # a model that takes media gets the group's stacked; the others
        # ignore a request's media, as the JAX engine's models do
        media = {}
        if self._takes_media and reqs[0].media is not None:
            media["media"] = torch.as_tensor(
                np.stack([r.media for r in reqs]), device=dev)

        if self.layout == "paged":
            logits, pc = self.model.prefill(prompts, plen)
            cache = self.cache
            l = cache["pages_k"].shape[0]
            # prefill rows land in the pool by a host-computed row list
            # (each shard its head slice under a mesh)
            rows = np.arange(plen)
            phys = torch.as_tensor(np.concatenate(
                [b[rows // ps].astype(np.int64) * ps + rows % ps
                 for b in blocks]), device=dev)
            for pk, src in (("pages_k", "k"), ("pages_v", "v")):
                kv = pc[src][:, :, :plen]
                PG.scatter_prefill(cache[pk], phys, kv.reshape(
                    (l, g * plen) + kv.shape[3:]))
            padded = np.full((g, self.max_pages), -1, np.int64)
            for i, b in enumerate(blocks):
                padded[i, : len(b)] = b
            cache["page_table"][slot_arr] = torch.as_tensor(padded,
                                                            device=dev)
            regions = np.concatenate([b[rows // ps] for b in blocks])
        else:
            # the group's cache overwrites the slots' lanes wholesale, every
            # leaf (KV lanes, recurrent states), and is freed right after
            if cfg.chunked:
                logits, pc = self._chunk_prefill_host(prompts, cfg.max_seq,
                                                      **media)
            else:
                logits, pc = self.model.prefill(prompts, cfg.max_seq,
                                                **media)
            for name, leaf in pc.items():
                self.cache[name][:, slot_arr] = leaf
            del pc
            regions = np.concatenate([
                s * self.max_pages + np.arange(plen) // ps for s in slots])
        # prefill writes are dense/contiguous -> offload path; they still
        # heat the page counters (the monitor sees every write that lands)
        self.mon_state = self.decision.heat(self.mon_state, regions)

        plist = [self._resolve_params(r) for r in reqs]
        t0s = torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int64)
        rem = np.asarray([p.max_tokens - 1 for p in plist], np.int64)
        stop_rows = np.asarray(
            [SMP.stop_table(p, cfg.eos_id) for p in plist], np.int64)
        done0 = (rem <= 0) | np.any(stop_rows == t0s[:, None], axis=1)
        self._set_slots(slots, reqs, plist, phase=PHASE_DECODE, token=t0s,
                        pos=np.full((g,), plen), done=done0, remaining=rem)
        for slot, req, t0, b in zip(slots, reqs, t0s, blocks):
            self._slot_pages[slot] = 0 if b is None else len(b)
            self.outputs[req.req_id] = [int(t0)]
            # admission-time prefill rows are bulk/offload writes
            self.req_writes[req.req_id] = np.asarray(
                [0, 0, req.prompt_len], np.int64)
        self._record_first_tokens([r.req_id for r in reqs])

    def _retire(self, slots: List[int]) -> None:
        for slot in slots:
            if self.pool is not None and not self._parked[slot]:
                self.pool.free_slot(slot)
            self._requests.pop(self._slot_req[slot], None)
            self._occupied[slot] = False
            self._slot_req[slot] = -1
            self._slot_plen[slot] = 0
            self._slot_max_new[slot] = 0
            self._slot_pages[slot] = 0
            self._slot_seq[slot] = -1
            self._slot_hashes[slot] = []
            self._slot_reg[slot] = 0
            self._slot_priority[slot] = 0
            self._parked[slot] = False
            self._host_store.pop(slot, None)
            self._draft_pos[slot] = -1
        if self.pool is not None and slots:
            self.cache["page_table"][
                torch.as_tensor(slots, device=self.device).long()] = -1
        self.stats["retired"] += len(slots)

    # -- preempt-and-requeue (sched/preempt, through the host tier) --

    def preempt_slot(self, victim: int, queue: RequestQueue) -> None:
        """Evict a RUNNING slot and put its request back at the queue head:
        its blocks unload to the host (the bulk copy ``_park`` makes), its
        scalars (phase / last token / position / remaining budget / key
        data) are saved on the host, and the slot retires on the device. On
        resume (``_try_resume``) everything is restored verbatim into
        whichever slot is free, so the continued stream is the unpreempted
        one: the saved key is loaded back, never derived again, and prefill
        steps never consumed a split. Unlike ``_park`` (which stalls a slot
        in place) preemption FREES the slot; the request re-enters through
        admission with its ORIGINAL seniority."""
        if not self._host_tier:
            raise RuntimeError(
                "preempt_slot needs memory.host_tier (the victim's KV "
                "parks in the host store)")
        done = self.done_flags()
        if (not self._occupied[victim] or self._parked[victim]
                or bool(done[victim])):
            raise ValueError(
                f"slot {victim} is not a preemptible running slot")
        self._check_drained(victim, "preempted")
        rid = self._slot_req[victim]
        st = self.slots
        blocks = list(self.pool.held(victim))
        host_k, host_v = PG.unload_blocks(self.cache, blocks)
        self._preempted[rid] = dict(
            n_pages=self._slot_pages[victim], host_k=host_k, host_v=host_v,
            phase=int(st.phase[victim]), token=int(st.token[victim]),
            pos=int(st.pos[victim]), remaining=int(st.remaining[victim]),
            key=st.key[victim].clone(), dkey=st.dkey[victim].clone(),
            seq=self._slot_seq[victim], plen=self._slot_plen[victim],
            max_new=self._slot_max_new[victim],
            hashes=self._slot_hashes[victim], reg=self._slot_reg[victim],
        )
        self.cache["page_table"][victim] = -1
        self.pool.free_slot(victim)
        done_t, rid_t = st.done.clone(), st.req_id.clone()
        done_t[victim], rid_t[victim] = True, -1
        self.slots = st._replace(done=done_t, req_id=rid_t)
        self._occupied[victim] = False
        self._slot_req[victim] = -1
        self._slot_plen[victim] = 0
        self._slot_max_new[victim] = 0
        self._slot_pages[victim] = 0
        self._slot_seq[victim] = -1
        self._slot_hashes[victim] = []
        self._slot_reg[victim] = 0
        self._slot_priority[victim] = 0
        queue.requeue(self._requests[rid])
        self.stats["preemptions"] += 1
        self.stats["host_unloads"] += len(blocks)

    def _try_resume(self, slot: int, req) -> bool:
        """Restore a preempted request into ``slot``: fresh blocks, one bulk
        host -> device copy per plane, the saved scalars and key written
        back verbatim. The sampling parameters come again from the
        request's RESOLVED params (deterministic, so exact). False when the
        pool cannot cover the saved pages (the request keeps its queue
        position)."""
        rid = req.req_id
        snap = self._preempted[rid]
        n = snap["n_pages"]
        got = self._alloc_reclaiming(slot, n, -1)
        if got is None:
            return False
        dev = self.device
        PG.load_blocks(self.cache, got, snap["host_k"], snap["host_v"])
        self.cache["page_table"][slot, :n] = torch.as_tensor(
            got, device=dev).long()
        if self._in_scan_prefill:
            padded = np.zeros((self.cfg.max_seq,), np.int64)
            padded[: req.prompt_len] = req.prompt
            self.prompts[slot] = torch.as_tensor(padded, device=dev)
        p = self.req_params[rid]
        st = self.slots
        values = dict(
            phase=snap["phase"], token=snap["token"], pos=snap["pos"],
            done=False, remaining=snap["remaining"], key=snap["key"],
            req_id=rid, plen=snap["plen"], temperature=p.temperature,
            top_k=p.top_k, top_p=p.top_p,
            stop=torch.as_tensor(SMP.stop_table(p, self.cfg.eos_id)),
            dkey=snap["dkey"])
        fields = {}
        for name, v in values.items():
            t = getattr(st, name).clone()
            t[slot] = torch.as_tensor(v, device=dev).to(t.dtype)
            fields[name] = t
        self.slots = st._replace(**fields)
        # the draft cache is derived data: resume marks the lane stale and
        # ``_sync_draft`` re-prefills it from the committed tokens
        self._draft_pos[slot] = -1
        self._occupied[slot] = True
        self._slot_req[slot] = rid
        self._slot_plen[slot] = snap["plen"]
        self._slot_max_new[slot] = snap["max_new"]
        self._slot_pages[slot] = n
        self._slot_seq[slot] = snap["seq"]  # original seniority
        self._slot_hashes[slot] = snap["hashes"]
        self._slot_reg[slot] = snap["reg"]
        self._slot_priority[slot] = req.priority
        del self._preempted[rid]
        self.stats["preempt_resumes"] += 1
        self.stats["host_pageins"] += n
        return True

    def _maybe_preempt(self, queue: RequestQueue) -> None:
        """The sched/preempt trigger, run before each admission scan: when
        every slot is busy and some WAITING request outranks the
        lowest-priority running slot STRICTLY (equal priorities never
        displace each other), evict that slot (the youngest among the
        lowest). One eviction frees one slot, so at most one victim per
        admission pass."""
        if not getattr(self._sched, "preempts", False) or len(queue) == 0:
            return
        if any(not o for o in self._occupied):
            return
        done = self.done_flags()
        running = [s for s in range(self.cfg.n_slots)
                   if self._occupied[s] and not self._parked[s]
                   and not bool(done[s])]
        if not running:
            return
        victim = min(running, key=lambda s: (self._slot_priority[s],
                                             -self._slot_seq[s]))
        wait_pri = max(queue.at(i).priority for i in range(len(queue)))
        if wait_pri > self._slot_priority[victim]:
            self.preempt_slot(victim, queue)

    def admit(self, queue: RequestQueue) -> int:
        """Admit waiting requests into free slots, scanning the queue in the
        admission policy's order (``cfg.sched``; FIFO = submission order).
        A request whose blocks can't be covered RIGHT NOW is skipped in
        favour of later ones that fit; it keeps its queue position.
        Skip-ahead is BOUNDED: after the scan-order head has been passed
        over ``skip_ahead_limit`` admission rounds in a row, scanning stops
        at it so freed blocks accumulate for it. A preempted request
        re-entering the queue resumes its saved state. Same-prompt-length
        requests admitted together share one batched prefill; chunked
        (paged) admission prefills nothing. Returns #admitted (resumes
        included)."""
        self._maybe_preempt(queue)
        picks: List[tuple] = []  # (slot, req, plan)
        free = [s for s in range(self.cfg.n_slots) if not self._occupied[s]]
        order = self._sched.order(queue)
        popped: List[int] = []  # original scan indices already admitted
        n_resumed = 0
        for k, oi in enumerate(order):
            if not free:
                break
            # translate the pass-start index to the queue's current
            # position: every already-popped earlier index shifts it left
            qi = oi - sum(1 for p in popped if p < oi)
            req = queue.at(qi)
            if req.prompt_len + req.max_new > self.cfg.max_seq:
                raise ValueError(
                    f"request {req.req_id}: prompt_len+max_new "
                    f"{req.prompt_len + req.max_new} > max_seq "
                    f"{self.cfg.max_seq}")
            if self.pool is not None:
                total = self._pages_needed(req.prompt_len, req.max_new)
                if total > self.pool.n_blocks:
                    raise ValueError(
                        f"request {req.req_id} needs {total} blocks; "
                        f"pool holds {self.pool.n_blocks}")
            if req.req_id in self._preempted:
                if self._try_resume(free[0], req):
                    free.pop(0)
                    queue.pop_at(qi)
                    popped.append(oi)
                    n_resumed += 1
                    if k == 0:
                        self._skip_rid, self._skip_count = -1, 0
                    continue
                plan = None
            else:
                plan = self._admission_plan(free[0], req)
            if plan is None:
                if k == 0:
                    if self._skip_rid != req.req_id:
                        self._skip_rid, self._skip_count = req.req_id, 0
                    self._skip_count += 1
                    if self._skip_count > self._skip_limit:
                        break  # head reserves every block freed from here on
                continue  # doesn't fit now: let later requests try
            if k == 0:
                self._skip_rid, self._skip_count = -1, 0
            picks.append((free.pop(0), queue.pop_at(qi), plan))
            popped.append(oi)
        if self._in_scan_prefill:
            if picks:
                self._admit_chunked([p[0] for p in picks],
                                    [p[1] for p in picks],
                                    [p[2] for p in picks])
            return len(picks) + n_resumed
        # group same-length prompts into one prefill dispatch each
        groups: Dict[int, List[tuple]] = {}
        for p in picks:
            groups.setdefault(p[1].prompt_len, []).append(p)
        for members in groups.values():
            self._admit_group([m[0] for m in members],
                              [m[1] for m in members],
                              [m[2] for m in members])
        return len(picks) + n_resumed

    # ------------------------------------------------------------------
    # the serve loop
    # ------------------------------------------------------------------
    def _mixed_phase_pending(self) -> bool:
        """Does the NEXT segment need the mixed-phase step? Only while a
        live slot is still prefilling: phases flip PREFILL -> DECODE only
        inside a segment, so a pure-decode start stays pure."""
        if not self._in_scan_prefill:
            return False
        phase = self.slots.phase.cpu().numpy()
        return bool(np.any(~self.done_flags() & (phase == PHASE_PREFILL)
                           & np.asarray(self._occupied)))

    @torch.no_grad()
    def _sync_draft(self) -> None:
        """Bring every live slot's draft lane up to its committed position
        (host, between segments). The draft cache is derived data:
        admission, a resume and a mixed segment leave a lane stale, and
        this re-prefills it from the prompt plus the emitted tokens whose
        KV the target has written (``pos - plen`` of them: the last emitted
        token's KV is not written yet), one exact-length prefill per stale
        slot (never padded to a bucket: a recurrent draft folds the whole
        sequence into its state), every leaf of its cache copied. Inside a
        spec segment the draft then stays in step with ``pos`` by
        construction."""
        cfg, dev = self.cfg, self.device
        pos = self.slots.pos.cpu().numpy()
        done = self.done_flags()
        for s in range(cfg.n_slots):
            if not self._occupied[s] or self._parked[s] or bool(done[s]):
                continue
            p = int(pos[s])
            if self._draft_pos[s] == p:
                continue
            rid, plen = self._slot_req[s], self._slot_plen[s]
            toks = np.concatenate([
                np.asarray(self._requests[rid].prompt[:plen], np.int64),
                np.asarray(self.outputs[rid][:p - plen], np.int64)])
            _, lane = self.draft_model.prefill(
                torch.as_tensor(toks, device=dev)[None], cfg.max_seq)
            for name, leaf in lane.items():
                self.draft_cache[name][:, s] = leaf[:, 0]
            del lane
            self._draft_pos[s] = p

    def run_segment(self, enabled: Optional[np.ndarray] = None) -> np.ndarray:
        """One segment (mixed-phase while a slot prefills, else speculative
        rounds when spec is on, else pure decode) + ONE host readback at its
        end. Returns the bool [segment_len, n_slots] emission matrix (a spec
        segment's: whether the slot committed anything in the round).
        ``enabled`` False stalls a slot whose block top-up failed."""
        if enabled is None:
            enabled = np.ones((self.cfg.n_slots,), bool)
        enabled_t = torch.as_tensor(enabled, device=self.device)
        mode = SMP.required_mode(
            [self.req_params[self._slot_req[s]]
             for s in range(self.cfg.n_slots) if self._occupied[s]])
        sstats = None
        if self._mixed_phase_pending():
            stats, swrites, emits, acts = self._mixed_segment(enabled_t, mode)
        elif self._spec_enabled:
            # every live slot decodes: sync the draft lanes, then rounds
            self._sync_draft()
            stats, sstats, swrites, emits, acts = self._spec_segment(
                enabled_t, mode)
        else:
            stats, swrites, emits, acts = self._decode_segment(enabled_t,
                                                               mode)
        # the readback: everything the host needs from this segment. Under a
        # mesh the decision plane is whole on the lead device (the JAX
        # engine's ``replicate_for_readback``), so it is read from there
        emits, acts = emits.cpu().numpy(), acts.cpu().numpy()
        swrites = swrites.cpu().numpy()
        d, s, dr, pf = (int(x) for x in stats.cpu().numpy())
        self.stats["direct_writes"] += d
        self.stats["staged_writes"] += s
        self.stats["drains"] += dr
        self.stats["prefill_writes"] += pf
        self.stats["segments"] += 1
        if sstats is not None:
            sp, sa, sc, sr = (int(x) for x in sstats.cpu().numpy())
            self.stats["spec_proposed"] += sp
            self.stats["spec_accepted"] += sa
            self.stats["spec_committed"] += sc
            self.stats["spec_rounds"] += sr
            committed = sc
        else:
            # the other segments commit exactly one token per emission
            committed = int(acts.sum())
        if self.time_model is not None:
            # virtual time: the segment "took" what the cost model says its
            # write mix costs; advance BEFORE stamping first tokens, so TTFT
            # includes the segment that produced them
            self.clock.advance(self.time_model(
                {"direct": d, "staged": s, "drains": dr, "prefill": pf,
                 "committed": committed}))
        first = []
        for slot in range(self.cfg.n_slots):
            if self._occupied[slot]:
                rid = self._slot_req[slot]
                self.req_writes[rid] += swrites[slot]
                # a spec segment's [T, S, k + 1] emissions: step-major, then
                # commit order within the round
                toks = emits[:, slot][acts[:, slot]]
                if len(toks):
                    if not self.outputs[rid]:
                        first.append(rid)
                    self.outputs[rid].extend(int(t) for t in toks)
        if first:
            self._record_first_tokens(first)
        if sstats is not None:
            # the draft stayed in step with pos inside the segment
            pos = self.slots.pos.cpu().numpy()
            for slot in range(self.cfg.n_slots):
                if self._occupied[slot] and not self._parked[slot]:
                    self._draft_pos[slot] = int(pos[slot])
            return acts.any(axis=2)
        return acts

    def done_flags(self) -> np.ndarray:
        """bool[n_slots] done flags, read back to the host."""
        return self.slots.done.cpu().numpy()

    def retire_done(self) -> int:
        """Free every occupied-but-done slot (host, between segments)."""
        done = self.done_flags()
        retiring = [s for s in range(self.cfg.n_slots)
                    if self._occupied[s] and bool(done[s])]
        self._retire(retiring)
        return len(retiring)

    def run_topped_up_segment(self, live: np.ndarray) -> np.ndarray:
        """Top up the live slots' blocks, then run one segment; raises when
        every live slot stalls (the pool cannot hold the working set)."""
        enabled = self._topup_blocks()
        if not (live & enabled).any():
            raise RuntimeError(
                "every live slot stalled on block top-up: the pool is too "
                "small for the admitted working set")
        return self.run_segment(enabled)

    def serve(self, queue: RequestQueue,
              max_segments: int = 100_000) -> Dict[int, np.ndarray]:
        """Drain the queue to completion: admit / run a segment / collect /
        retire, until no request is live. Returns {req_id: tokens}."""
        if self._t_serve0 is None:
            self._t_serve0 = self._now()
        for _ in range(max_segments):
            self.retire_done()
            self.admit(queue)
            if not any(self._occupied):
                if len(queue) == 0:
                    break
                raise RuntimeError(
                    "queue head unadmittable with an empty engine "
                    "(request larger than pool capacity?)")
            live = ~self.done_flags() & np.asarray(self._occupied)
            if not live.any():
                continue
            self.run_topped_up_segment(live)
        else:
            raise RuntimeError(f"serve() exceeded {max_segments} segments")
        return {rid: np.asarray(t, np.int32)
                for rid, t in self.outputs.items()}
