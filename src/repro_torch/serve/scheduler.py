"""Port of repro/serve/scheduler.py (blocking admission, paged layout).

Continuous-batching serve scheduler over the paged KV pool: a fixed array of
serving SLOTS decodes in lock-step, each slot at its own position in its own
request, so the DecisionModule sees an interleaved multi-tenant write stream
(per-slot destination blocks in a SHARED physical pool).

* **SlotState**: per-slot token / position / done-flag / remaining-budget /
  request-id / stop table, fixed-shape tensors on the engine's device.
  Retirement is in-segment: a slot whose emitted token hits a stop token or
  whose budget is spent flips ``done`` and from the next step neither writes
  KV (its destination resolves to the sink) nor updates the monitor.
* **Segments**: where the JAX package jits a ``lax.scan``, a segment here is
  a Python loop of ``segment_len`` eager steps over preallocated device
  tensors with NO host read inside the loop and one readback at its end.
  The conditional drain never asks the host whether it is due (see
  ``kvcache.paged.maybe_drain``). The segment boundary forces a drain, so the
  host never frees a block with staged bytes in flight.
* **Admission**: between segments, on the host. The FIFO ``RequestQueue`` is
  scanned in submission order and a request that does not fit is skipped in
  favour of later ones that do (bounded by ``skip_ahead_limit``). Prompts
  are prefilled at admission, same-length prompts in one batched call; the
  rows land in the pool by a host-computed physical row list.
* **KV writes**: every decode-time write resolves through the page table to
  a physical pool row; direct writes scatter straight in, staged writes ride
  the per-slot ring overlay and drain in bulk through
  ``core.ring.scatter_rows_layers``. The monitor's region is the BLOCK id.

Chunked in-segment prefill, the lanes layout, the prefix cache, the host
tier, preemption, speculative decoding, mesh sharding and the virtual-time
cost model are not ported yet (``core.paths.validate`` raises on each).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..core.paths import MemoryConfig, normalize_groups, validate
from ..core.types import WriteBatch, make_write_batch
from ..data.pipeline import RequestQueue
from ..kvcache import paged as PG
from ..models import sampling as SMP
from ..models.sampling import SamplingParams, SlotParams
from ..models.transformer import DecoderLM, compute_dtype

PHASE_PREFILL = 0
PHASE_DECODE = 1


def paged_capable(model) -> bool:
    """Can this model serve from the paged pool? Linear-addressed dense
    ``DecoderLM`` only."""
    return (isinstance(model, DecoderLM)
            and not model.is_vlm
            and not model.cfg.sliding_window)


class SlotState(NamedTuple):
    """Fixed slot array: the whole scheduler state a segment carries.

    phase:     int[S]  PHASE_DECODE (blocking admission prefills up front)
    token:     int[S]  last emitted token (next decode step's input)
    pos:       int[S]  next logical row to write
    done:      bool[S] retired (or never admitted)
    remaining: int[S]  tokens the slot may still emit
    key:       int[S, 2] per-slot PRNG key data (unused by greedy decoding)
    req_id:    int[S]  owning request id (-1 = empty)
    plen:      int[S]  prompt length
    temperature f32[S]; top_k int[S]; top_p f32[S];
    stop       int[S, MAX_STOP_TOKENS] stop-token table (-1 padded)
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

    @property
    def sampling(self) -> SlotParams:
        return SlotParams(temperature=self.temperature, top_k=self.top_k,
                          top_p=self.top_p, stop=self.stop)


def make_slots(n_slots: int, device="cpu") -> SlotState:
    sp = SMP.make_slot_params(n_slots, device)

    def ints(fill, *shape):
        return torch.full(shape or (n_slots,), fill, dtype=torch.int64,
                          device=device)

    return SlotState(
        phase=ints(PHASE_DECODE), token=ints(0), pos=ints(0),
        done=torch.ones((n_slots,), dtype=torch.bool, device=device),
        remaining=ints(0), key=ints(0, n_slots, 2), req_id=ints(-1),
        plen=ints(0), temperature=sp.temperature, top_k=sp.top_k,
        top_p=sp.top_p, stop=sp.stop,
    )


@dataclasses.dataclass
class BatchConfig:
    """Continuous-batching engine configuration. ``max_seq`` bounds
    prompt_len + max_new per request; ``n_blocks = 0`` sizes the pool for
    zero contention. ``path``/``policy`` name a registered WritePath and
    RoutingPolicy; ``attention`` picks the paged read implementation
    (``auto`` | ``fused`` | ``reference``); ``device`` is where the engine
    runs (``"cuda"`` raises on a machine without it). The remaining fields
    mirror the JAX package's and raise "not ported yet" when switched on."""

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
                        arch_name=model.cfg.name)
        self.plan = plan
        self.device = plan.device
        if model.device.type != self.device.type:
            raise ValueError(
                f"model lives on {model.device} but the engine was asked "
                f"for {self.device}")
        if self.device.type == "cuda":
            # fp32 matrix products stay full fp32 (the default, stated)
            torch.backends.cuda.matmul.allow_tf32 = False
        self.layout = plan.layout
        self._skip_limit = plan.memory.skip_ahead_limit
        self._sched = plan.sched
        self.max_pages = plan.max_pages
        self.n_blocks = plan.n_blocks
        self.path, self.decision = plan.path, plan.decision
        self.uses_ring = self.path.uses_ring
        self.attention = plan.attention
        self.clock: Callable[[], float] = time.perf_counter
        self.stats = {
            "direct_writes": 0, "staged_writes": 0, "drains": 0,
            "prefill_writes": 0, "segments": 0, "admitted": 0, "retired": 0,
        }
        self.reset()

    def _make_cache(self) -> PG.PagedKV:
        cfg, mcfg = self.cfg, self.model.cfg
        return PG.make_paged_kv(
            mcfg.n_layers, self.n_blocks, cfg.page_size, cfg.n_slots,
            self.max_pages, mcfg.n_kv_heads, mcfg.resolved_head_dim,
            dtype=compute_dtype(mcfg),
            ring_size=cfg.ring_size if self.uses_ring else 0,
            device=self.device)

    def reset(self) -> None:
        """Fresh serving state (cache, slots, pool, monitor, outputs)."""
        cfg = self.cfg
        self.pool = PG.BlockPool(self.n_blocks)
        self.cache = None  # release the old pool before allocating anew
        self.cache = self._make_cache()
        self.slots = make_slots(cfg.n_slots, self.device)
        self.mon_state = self.decision.init_state(self.device)
        # constant tail of every step's WriteBatch (offset/size/hint/phase)
        self._batch_tail = tuple(make_write_batch(
            torch.zeros((cfg.n_slots,), device=self.device))[1:])
        # host-side shadows (device round-trips happen once per segment)
        self._occupied = [False] * cfg.n_slots
        self._slot_req: List[int] = [-1] * cfg.n_slots
        self._slot_plen: List[int] = [0] * cfg.n_slots
        self._slot_max_new: List[int] = [0] * cfg.n_slots
        self._slot_pages: List[int] = [0] * cfg.n_slots
        self._skip_rid = -1
        self._skip_count = 0
        self.outputs: Dict[int, List[int]] = {}
        self.ttft: Dict[int, float] = {}
        # per-request telemetry: resolved SamplingParams and write-path
        # counts [direct, staged, prefill] (the Completion payload)
        self.req_params: Dict[int, SamplingParams] = {}
        self.req_writes: Dict[int, np.ndarray] = {}
        self._t_serve0: Optional[float] = None
        self.req_arrival: Dict[int, float] = {}
        self.first_token_t: Dict[int, float] = {}
        self.stats = {k: 0 for k in self.stats}

    # ------------------------------------------------------------------
    # the decode segment
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _decode_segment(self, enabled: torch.Tensor, mode: str):
        """``segment_len`` decode steps: every live slot samples one token
        per step. Nothing in here reads a device value on the host."""
        model, cfg, dev = self.model, self.cfg, self.device
        ring = self.uses_ring
        ps, nb = cfg.page_size, self.n_blocks
        decision, attn = self.decision, self.attention
        cache, st, mon = self.cache, self.slots, self.mon_state
        t_len, s = cfg.segment_len, cfg.n_slots
        # page-table products are segment-invariant (allocation is
        # host-side, between segments): derive them once
        plan = PG.step_plan(cache)
        stats = torch.zeros((4,), dtype=torch.int64, device=dev)
        swrites = torch.zeros((s, 3), dtype=torch.int64, device=dev)
        emits = torch.full((t_len, s), -1, dtype=torch.int64, device=dev)
        acts = torch.zeros((t_len, s), dtype=torch.bool, device=dev)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        zeros_s = torch.zeros((s,), dtype=torch.int64, device=dev)
        for t in range(t_len):
            active = ~st.done & enabled
            live_pos = torch.where(active, st.pos, -1)
            dest = PG.logical_to_physical(cache, live_pos)
            region = torch.clamp(dest // ps, max=nb - 1)
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
            else:
                logits, cache = model.decode_step_paged(
                    cache, st.token, st.pos, active, attention=attn,
                    plan=plan)
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

    # ------------------------------------------------------------------
    # admission / retirement / allocation (host, between segments)
    # ------------------------------------------------------------------
    def _pages_needed(self, plen: int, max_new: int) -> int:
        # decode writes rows plen .. plen+max_new-2 (the final emitted
        # token is never consumed, so its KV is never written)
        return max(1, -(-(plen + max_new - 1) // self.cfg.page_size))

    def _resolve_params(self, req) -> SamplingParams:
        p = SMP.resolve(req.params, self.cfg.default_params, self.cfg.greedy)
        if p.temperature > 0:
            raise NotImplementedError(
                f"not ported yet: sampled decoding (request {req.req_id} "
                f"has temperature {p.temperature}); greedy only")
        return p

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
        """Reserve ``req``'s whole footprint for ``slot``: the one place
        admission touches the pool. None when the pool can't cover it (the
        request keeps its queue position)."""
        blocks = self.pool.alloc(
            slot, self._pages_needed(req.prompt_len, req.max_new))
        if blocks is None:
            return None
        return {"blocks": blocks}

    @torch.no_grad()
    def _admit_group(self, slots: List[int], reqs: List[Any],
                     plans: List[dict]) -> None:
        """Admit a group of same-prompt-length requests with ONE batched
        prefill + ONE insert + ONE slot-state update."""
        cfg, dev = self.cfg, self.device
        if any(r.media is not None for r in reqs):
            raise NotImplementedError("not ported yet: requests with media")
        blocks = [p["blocks"] for p in plans]
        g, plen = len(reqs), reqs[0].prompt_len
        ps = cfg.page_size
        prompts = torch.as_tensor(np.stack([r.prompt for r in reqs]),
                                  device=dev).long()
        slot_arr = torch.as_tensor(slots, device=dev).long()

        logits, pc = self.model.prefill(prompts, plen)
        cache = self.cache
        l = cache["pages_k"].shape[0]
        # prefill rows land in the pool by a host-computed row list
        rows = np.arange(plen)
        phys = torch.as_tensor(np.concatenate(
            [b[rows // ps].astype(np.int64) * ps + rows % ps
             for b in blocks]), device=dev)
        for pk, src in (("pages_k", "k"), ("pages_v", "v")):
            tail = cache[pk].shape[3:]
            flat = cache[pk].view((l, -1) + tail)
            flat.index_copy_(1, phys, pc[src][:, :, :plen].reshape(
                (l, g * plen) + tail))
        padded = np.full((g, self.max_pages), -1, np.int64)
        for i, b in enumerate(blocks):
            padded[i, : len(b)] = b
        cache["page_table"][slot_arr] = torch.as_tensor(padded, device=dev)
        regions = np.concatenate([b[rows // ps] for b in blocks])
        # prefill writes are dense/contiguous -> offload path; they still
        # heat the page counters (the monitor sees every write that lands)
        self.mon_state = self.decision.heat(self.mon_state, regions)

        plist = [self._resolve_params(r) for r in reqs]
        t0s = torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int64)
        rem = np.asarray([p.max_tokens - 1 for p in plist], np.int64)
        stop_rows = np.asarray(
            [SMP.stop_table(p, cfg.eos_id) for p in plist], np.int64)
        done0 = (rem <= 0) | np.any(stop_rows == t0s[:, None], axis=1)

        def put(old, values, dtype=None):
            new = old.clone()
            new[slot_arr] = torch.as_tensor(
                values, device=dev).to(dtype or old.dtype)
            return new

        st = self.slots
        self.slots = st._replace(
            phase=put(st.phase, np.full((g,), PHASE_DECODE)),
            token=put(st.token, t0s),
            pos=put(st.pos, np.full((g,), plen)),
            done=put(st.done, done0),
            remaining=put(st.remaining, rem),
            req_id=put(st.req_id, np.asarray([r.req_id for r in reqs])),
            plen=put(st.plen, np.full((g,), plen)),
            key=put(st.key, np.zeros((g, 2), np.int64)),
            temperature=put(st.temperature,
                            np.asarray([p.temperature for p in plist],
                                       np.float32)),
            top_k=put(st.top_k, np.asarray([p.top_k for p in plist])),
            top_p=put(st.top_p,
                      np.asarray([p.top_p for p in plist], np.float32)),
            stop=put(st.stop, stop_rows),
        )
        for slot, req, p, t0, b in zip(slots, reqs, plist, t0s, blocks):
            self._occupied[slot] = True
            self._slot_req[slot] = req.req_id
            self._slot_plen[slot] = req.prompt_len
            self._slot_max_new[slot] = p.max_tokens
            self._slot_pages[slot] = len(b)
            self.req_arrival[req.req_id] = req.arrival_s
            self.outputs[req.req_id] = [int(t0)]
            self.req_params[req.req_id] = p
            # admission-time prefill rows are bulk/offload writes
            self.req_writes[req.req_id] = np.asarray(
                [0, 0, req.prompt_len], np.int64)
        self._record_first_tokens([r.req_id for r in reqs])
        self.stats["admitted"] += g

    def _retire(self, slots: List[int]) -> None:
        for slot in slots:
            self.pool.free_slot(slot)
            self._occupied[slot] = False
            self._slot_req[slot] = -1
            self._slot_plen[slot] = 0
            self._slot_max_new[slot] = 0
            self._slot_pages[slot] = 0
        if slots:
            self.cache["page_table"][
                torch.as_tensor(slots, device=self.device).long()] = -1
        self.stats["retired"] += len(slots)

    def admit(self, queue: RequestQueue) -> int:
        """Admit waiting requests into free slots, scanning the queue in the
        admission policy's order (FIFO). A request whose blocks can't be
        covered RIGHT NOW is skipped in favour of later ones that fit; it
        keeps its queue position. Skip-ahead is BOUNDED: after the head
        request has been passed over ``skip_ahead_limit`` admission rounds
        in a row, scanning stops at it so freed blocks accumulate for it.
        Same-prompt-length requests admitted together share one batched
        prefill. Returns #admitted."""
        picks: List[tuple] = []  # (slot, req, plan)
        free = [s for s in range(self.cfg.n_slots) if not self._occupied[s]]
        order = self._sched.order(queue)
        popped: List[int] = []  # original scan indices already admitted
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
            total = self._pages_needed(req.prompt_len, req.max_new)
            if total > self.pool.n_blocks:
                raise ValueError(
                    f"request {req.req_id} needs {total} blocks; "
                    f"pool holds {self.pool.n_blocks}")
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
        # group same-length prompts into one prefill dispatch each
        groups: Dict[int, List[tuple]] = {}
        for p in picks:
            groups.setdefault(p[1].prompt_len, []).append(p)
        for members in groups.values():
            self._admit_group([m[0] for m in members],
                              [m[1] for m in members],
                              [m[2] for m in members])
        return len(picks)

    # ------------------------------------------------------------------
    # the serve loop
    # ------------------------------------------------------------------
    def run_segment(self, enabled: Optional[np.ndarray] = None) -> np.ndarray:
        """One decode segment + ONE host readback at its end. Returns the
        bool [segment_len, n_slots] emission matrix."""
        if enabled is None:
            enabled = np.ones((self.cfg.n_slots,), bool)
        enabled_t = torch.as_tensor(enabled, device=self.device)
        mode = SMP.required_mode(
            [self.req_params[self._slot_req[s]]
             for s in range(self.cfg.n_slots) if self._occupied[s]])
        stats, swrites, emits, acts = self._decode_segment(enabled_t, mode)
        # the readback: everything the host needs from this segment
        emits, acts = emits.cpu().numpy(), acts.cpu().numpy()
        swrites = swrites.cpu().numpy()
        d, s, dr, pf = (int(x) for x in stats.cpu().numpy())
        self.stats["direct_writes"] += d
        self.stats["staged_writes"] += s
        self.stats["drains"] += dr
        self.stats["prefill_writes"] += pf
        self.stats["segments"] += 1
        first = []
        for slot in range(self.cfg.n_slots):
            if self._occupied[slot]:
                rid = self._slot_req[slot]
                self.req_writes[rid] += swrites[slot]
                toks = emits[acts[:, slot], slot]
                if len(toks):
                    if not self.outputs[rid]:
                        first.append(rid)
                    self.outputs[rid].extend(int(t) for t in toks)
        if first:
            self._record_first_tokens(first)
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
            self.run_segment()
        else:
            raise RuntimeError(f"serve() exceeded {max_segments} segments")
        return {rid: np.asarray(t, np.int32)
                for rid, t in self.outputs.items()}
