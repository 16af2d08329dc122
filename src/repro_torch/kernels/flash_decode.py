"""Port of repro/kernels/flash_decode.py (+ ``flash_decode_paged_ref`` and
``flash_decode_ref`` of repro/kernels/ref.py): the fused paged read and the
dense (lanes-layout) decode read.

Source note, ``flash_decode_paged``
-----------------------------------
Replaces the Pallas TPU kernel ``repro/kernels/flash_decode.py:135
flash_decode_paged`` (``_paged_kernel`` :70): softmax(q.K^T * D^-1/2,
masked to -1e30) over (pool rows reached through the page table) U
(staging-ring lanes), fp32 softmax, times V. The TPU kernel parks every
score and value of a slot in VMEM and runs one full-width softmax at the
last page; that does not fit a Hopper block. Bound: bytes, those of the K
and V rows that some query column of their slot sees (a masked key adds
exactly 0 wherever a live one exists), ``n_live * Hkv * D * 2 * elemsize``;
in the engine a slot's live keys are a prefix of its 2048-row view and the
rest of its page table is clamped to block 0. ``csrc/flash_decode_paged.cu``
reads those rows once and nothing else: one pass with an online softmax
(per 16 keys one max and one rescale; q.k rounded to the I/O type as the
JAX oracle ``ref.flash_decode_paged_ref`` and the plain version round it,
where the Pallas kernel keeps fp32 scores, so in bf16 this kernel follows
the oracle's precision and not the TPU kernel's; the unnormalised
probabilities rounded to the I/O type for P.V, l in fp32, as
``flash_decode``); each block turns
its slot's ``view_ok`` into bit planes and loads only the live units (a
page some query column sees a key of; the ring when a lane is live); a
key no query row of the block sees is not read either. A slot
with a query column that sees no key at all counts every unit live and
scores masked keys -1e30, the plain version's uniform mean (the dead-row
rule, decided before any K/V row is read). The live units of a (slot, KV
head, 16 query rows) are shared in page order among the blocks of a
thread-block cluster (split s of n takes live units ``[s n_live / n,
(s + 1) n_live / n)``), merged by log-sum-exp through
distributed shared memory: one launch a call; the number of splits comes
from the shapes and the SM count only (``_paged_splits``). Pages arrive by
cp.async in 16-byte pieces, each warp walking its own 16-key chunks through
a ring of stages; the C x G query rows are scored 16 at a time on the
tensor cores (``mma.sync``), float32 on the CUDA cores.

Source note, ``flash_decode_paged_sharded``
-------------------------------------------
Replaces the TPU kernel under ``shard_map``
(``repro/kernels/flash_decode.py:207 flash_decode_paged_sharded``): K2 per
head shard, each shard on its own device. Bound: K2's, the bytes of the
live keys, which sharding does not change. ``csrc/flash_decode_paged.cu``
takes the pool and ring planes as a table of head shards (base pointers,
passed by value): KV head ``h`` of the grid reads shard ``h / hkv_s``. So
the wrapper launches ONE grid per device over the shards there
(``device_groups``), at the unsharded split count: a virtual mesh of one
card is one launch a read with q read whole and nothing joined (four
quarter-full launches, four q slices and a join before), a mesh of
distinct cards one launch a card, the outputs joined on the lead. Each
head's result is unsharded K2's bit for bit.

Source note, ``flash_decode``
-----------------------------
Replaces the Pallas TPU kernel ``repro/kernels/flash_decode.py::
flash_decode`` (``_decode_kernel``): one query row per head against a dense
``[B, T, Hkv, D]`` cache masked by ``kv_mask [B, T]``. Bound: bytes, those of
the live K and V rows (``n_live * Hkv * D * 2 * elemsize``) plus q, the mask
and the output. ``csrc/flash_decode.cu``: one block per (key split, KV head,
16 query rows, slot) serves the head's GQA group, so each row leaves device
memory once; bf16 K/V tiles of 128 keys arrive by TMA through a ring of
three stages (tiles with no live key unread; fp32: 64-key tiles by
``cp.async``, masked keys unread); each warp scores its 16 keys on the
tensor cores (the rows padded to 16), with one max and one rescale per tile.
The splits of one (slot, head, rows) form a thread-block cluster and merge by
log-sum-exp through distributed shared memory at the end of the same kernel:
one launch a call. The split plan (``_splits``) depends on the shapes and
the card's SM count only, so a result never depends on timing. A slot with
no live key gives the plain version's finite uniform mean over all T rows
(the Pallas kernel gives 0 there; the paged reference read hands dead slots
to this function, and the port follows ``ref``/``sdpa`` as K2 does). The
kernel rounds the unnormalised probabilities to bf16 for P.V and keeps l in
fp32; the plain version rounds the normalised ones, about one output ulp
apart in bf16. float32 runs the same structure on the CUDA cores.

On a CPU tensor the wrappers run the plain versions; on a CUDA tensor they
launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .cost import H100_SMS, is_meta, k4_cost, record

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# devices on which K2 may take its shared memory (``..._prepare`` ran)
_PAGED_READY = set()


def flash_decode_paged_ref(
    q: torch.Tensor,        # [B, C, Hq, D]
    pages_k: torch.Tensor,  # [n_blocks, ps, Hkv, D] physical pool (one layer)
    pages_v: torch.Tensor,
    blocks: torch.Tensor,   # int [B, P] physical block ids (clamped >= 0)
    view_ok: torch.Tensor,  # bool [B, C, P*ps]
    ring_k: Optional[torch.Tensor] = None,   # [B, R, Hkv, D]
    ring_v: Optional[torch.Tensor] = None,
    ring_ok: Optional[torch.Tensor] = None,  # bool [B, R]
) -> torch.Tensor:
    """Plain PyTorch version: gather the per-slot view through the page
    table, append the staging-ring lanes, then the ``layers._sdpa_once`` op
    order (fp32 logits -> mask -> softmax -> dtype cast -> weighted sum)."""
    b, c, hq, d = q.shape
    ps, hkv = pages_k.shape[1], pages_k.shape[2]
    rows = (blocks.long()[:, :, None] * ps
            + torch.arange(ps, device=q.device)[None, None, :]).reshape(b, -1)
    flat_k = pages_k.reshape(-1, hkv, d)
    flat_v = pages_v.reshape(-1, hkv, d)
    k = flat_k[rows]           # [B, P*ps, Hkv, D]
    v = flat_v[rows]
    mask = view_ok.bool()      # [B, C, P*ps]
    if ring_k is not None:
        k = torch.cat([k, ring_k], dim=1)
        v = torch.cat([v, ring_v], dim=1)
        mask = torch.cat(
            [mask, ring_ok.bool()[:, None, :].expand(b, c, ring_ok.shape[1])],
            dim=2)
    if hkv != hq:
        reps = hq // hkv
        k = k.repeat_interleave(reps, dim=2)
        v = v.repeat_interleave(reps, dim=2)
    logits = torch.einsum("bchd,bthd->bhct", q, k).float()
    logits = logits * (d ** -0.5)
    logits = torch.where(mask[:, None], logits,
                         torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhct,bthd->bchd", probs, v)


def _check(q, pages_k, pages_v, blocks, view_ok, ring_k, ring_v, ring_ok):
    if q.dim() != 4 or pages_k.dim() != 4:
        raise ValueError("q must be [B,C,Hq,D] and pages [n_blocks,ps,Hkv,D]")
    b, c, hq, d = q.shape
    nb, ps, hkv, dk = pages_k.shape
    if dk != d or pages_v.shape != pages_k.shape or hq % hkv:
        raise ValueError(f"bad head geometry: q {tuple(q.shape)}, pages_k "
                         f"{tuple(pages_k.shape)}, pages_v "
                         f"{tuple(pages_v.shape)}")
    if blocks.dim() != 2 or blocks.shape[0] != b:
        raise ValueError(f"blocks must be [B, P], got {tuple(blocks.shape)}")
    p = blocks.shape[1]
    if view_ok.shape != (b, c, p * ps):
        raise ValueError(f"view_ok must be {(b, c, p * ps)}, got "
                         f"{tuple(view_ok.shape)}")
    ring = ring_k is not None
    if ring:
        if ring_v is None or ring_ok is None:
            raise ValueError("ring_k needs ring_v and ring_ok")
        r = ring_k.shape[1]
        if ring_k.shape != (b, r, hkv, d) or ring_v.shape != ring_k.shape \
                or ring_ok.shape != (b, r):
            raise ValueError("ring planes must be [B,R,Hkv,D], ring_ok [B,R]")
    ts = [q, pages_k, pages_v] + ([ring_k, ring_v] if ring else [])
    if any(t.dtype != q.dtype for t in ts):
        raise TypeError("q, pages and ring planes must share one dtype")
    if any(t.device != q.device for t in ts + [blocks, view_ok]
           + ([ring_ok] if ring else [])):
        raise ValueError("all flash_decode_paged operands must share a device")


def flash_decode_paged(q, pages_k, pages_v, blocks, view_ok,
                       ring_k=None, ring_v=None, ring_ok=None) -> torch.Tensor:
    """Fused paged decode: page-table walk + staging-ring overlay + SDPA.
    Returns ``[B, C, Hq, D]`` in ``q.dtype``: one launch, a table of one
    head shard (``_paged_launch``)."""
    _check(q, pages_k, pages_v, blocks, view_ok, ring_k, ring_v, ring_ok)
    if q.device.type == "cpu":
        return flash_decode_paged_ref(q, pages_k, pages_v, blocks, view_ok,
                                      ring_k, ring_v, ring_ok)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = paged_kernel_plan(q, pages_k, pages_v, blocks, ring_k, ring_v, sms)
    out, launches = _paged_launch(q, [(pages_k, pages_v, ring_k, ring_v)],
                                  blocks, view_ok, ring_ok, plan)
    flash_decode_paged.launches += launches
    return out


flash_decode_paged.launches = 0

# head shards one K2 launch reads (``csrc/flash_decode_paged.cu::kMaxShards``);
# a larger table launches once per this many
MAX_SHARDS = 16


def shard_launches(n_shards: int, hkv_s: int):
    """The K2 launches that read a table of ``n_shards`` head shards of
    ``hkv_s`` KV heads each: ``[(first shard, end shard, first KV head)]``,
    one per ``MAX_SHARDS`` shards."""
    return [(j, min(j + MAX_SHARDS, n_shards), j * hkv_s)
            for j in range(0, n_shards, MAX_SHARDS)]


def _paged_launch(q, shards, blocks, view_ok, ring_ok, n_split):
    """K2 over a table of head shards on q's device: ``shards`` is a list of
    ``(pages_k, pages_v, ring_k, ring_v)``, each ``[n_blocks, ps, hkv_s,
    D]`` / ``[B, R, hkv_s, D]``, shard j holding KV heads ``[j hkv_s, (j +
    1) hkv_s)`` of q's. One launch per ``MAX_SHARDS`` shards
    (``shard_launches``), each writing its heads of one output. Returns
    ``([B, C, Hq, D], launches)``."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_decode_paged takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if not shards:
        raise ValueError("flash_decode_paged: no head shard to read")
    b, c, hq, d = q.shape
    pk0 = shards[0][0]
    ps, hkv_s = pk0.shape[1], pk0.shape[2]
    hkv = hkv_s * len(shards)
    if hq % hkv or any(x.shape != pk0.shape for s in shards for x in s[:2]):
        raise ValueError(f"flash_decode_paged: {len(shards)} shards of "
                         f"{tuple(pk0.shape)} do not read q {tuple(q.shape)}")
    p = blocks.shape[1]
    r = 0 if shards[0][2] is None else shards[0][2].shape[1]
    for pk, pv, rk, rv in shards:
        _kernel_takes(q, pk, pv, rk, rv, p, hq // hkv)
    blocks32 = blocks.to(torch.int32).contiguous()
    vok = view_ok.to(torch.bool).contiguous()
    rok = ring_ok.to(torch.bool).contiguous() if r else None

    def ptrs(part, i):
        return (ctypes.c_void_p * len(part))(
            *[sh[i].data_ptr() if sh[i] is not None else None for sh in part])
    out = torch.empty_like(q)
    launches = shard_launches(len(shards), hkv_s)
    with build.on_device(q.device):
        lib = build.load_library()
        if q.device.index not in _PAGED_READY:
            err = lib.flash_decode_paged_prepare()
            if err != 0:
                raise RuntimeError(f"flash_decode_paged: shared-memory limit "
                                   f"refused, CUDA error {err}")
            _PAGED_READY.add(q.device.index)
        for lo, hi, h0 in launches:
            part = shards[lo:hi]
            err = lib.flash_decode_paged_launch(
                q.data_ptr(), len(part), ptrs(part, 0), ptrs(part, 1),
                ptrs(part, 2), ptrs(part, 3), blocks32.data_ptr(),
                vok.data_ptr(), rok.data_ptr() if r else None,
                out.data_ptr(), b, c, hq, hkv, d, p, ps, r, n_split, hkv_s,
                h0, float(d ** -0.5), _DTYPES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
            if err != 0:
                raise RuntimeError(
                    f"flash_decode_paged launch failed: CUDA error {err}")
    return out, len(launches)


def _head_pieces(x, axis: str, mesh, devices):
    """``x`` (``[..., H, D]``) as one head slice per read device of
    ``axis``, each on its device: a ``ShardedTensor`` split on ``axis``
    gives its own pieces; a whole tensor, or the lead's copy of a replicated
    one, is cut here (each slice made contiguous on its device)."""
    from ..distributed.sharding import ShardedTensor

    if x is None:
        return [None] * len(devices)
    if isinstance(x, ShardedTensor):
        if x.axis is not None and mesh.shape[x.mesh_axis] > 1:
            if x.mesh_axis != axis or x.axis != x.dim() - 2:
                raise ValueError(
                    f"flash_decode_paged_sharded: a placed operand must be "
                    f"split on its head axis over {axis!r}")
            return [p for _, p in x.read_group()]
        x = x.shards[0]
    return [part.to(d).contiguous()
            for part, d in zip(x.chunk(len(devices), dim=-2), devices)]


def device_groups(mesh, axis: str = "model"):
    """The read devices of ``axis`` grouped by device: ``[(device, [shard
    positions on it])]``, devices in the order of their first shard, each
    list ascending. One group when every shard sits on one device (a
    virtual mesh), one per card on a mesh of distinct cards; ``[(lead,
    [0])]`` where ``axis`` is missing or has size 1."""
    from ..distributed.sharding import axis_size

    if axis_size(mesh, axis) <= 1:
        return [(mesh.lead, [0])]
    groups = {}
    for j, i in enumerate(mesh.axis_group(axis)):
        groups.setdefault(mesh.devices[i], []).append(j)
    return list(groups.items())


def _per_device(fn, mesh, axis, q, pages_k, pages_v, blocks, view_ok,
                ring_k, ring_v, ring_ok):
    """``fn(q_d, [(pages_k, pages_v, ring_k, ring_v) of each shard on the
    device], blocks, view_ok, ring_ok)`` once per device of ``axis``
    (``device_groups``), the routing inputs copied there. On one device q
    is whole and its output is the result; on several, each device reads
    the q heads of its shards and the outputs are joined on the head axis
    in shard order on ``mesh.lead``."""
    groups = device_groups(mesh, axis)
    where = {j: d for d, js in groups for j in js}
    devices = [where[j] for j in range(len(where))]
    planes = [_head_pieces(x, axis, mesh, devices)
              for x in (pages_k, pages_v, ring_k, ring_v)]

    def call(qd, dev, js):
        return fn(qd, [tuple(x[j] for x in planes) for j in js],
                  blocks.to(dev), view_ok.to(dev),
                  None if ring_ok is None else ring_ok.to(dev))
    if len(groups) == 1:
        dev, js = groups[0]
        return call(q.to(dev), dev, js)
    hs = q.shape[2] // len(devices)
    outs = {}
    for dev, js in groups:
        qd = torch.cat([q[:, :, j * hs:(j + 1) * hs] for j in js], dim=2)
        out = call(qd.to(dev), dev, js)
        for k, j in enumerate(js):
            outs[j] = out[:, :, k * hs:(k + 1) * hs]
    return torch.cat([outs[j].to(mesh.lead) for j in range(len(devices))],
                     dim=2)


def _plain_read(q, shards, blocks, view_ok, ring_ok):
    """One device's read, plain: its shards' planes joined on the head axis,
    one ``flash_decode_paged_ref`` call."""
    def join(i):
        xs = [sh[i] for sh in shards]
        if xs[0] is None:
            return None
        return xs[0] if len(xs) == 1 else torch.cat(xs, dim=-2)
    return flash_decode_paged_ref(q, join(0), join(1), blocks, view_ok,
                                  join(2), join(3), ring_ok)


def flash_decode_paged_sharded_ref(mesh, q, pages_k, pages_v, blocks,
                                   view_ok, ring_k=None, ring_v=None,
                                   ring_ok=None, *, axis: str = "model"):
    """Plain version of :func:`flash_decode_paged_sharded`, grouped by device
    as the kernel is: per device, its shards' planes joined on the head
    axis and one ``flash_decode_paged_ref`` call."""
    return _per_device(_plain_read, mesh, axis, q, pages_k, pages_v, blocks,
                       view_ok, ring_k, ring_v, ring_ok)


def flash_decode_paged_sharded(mesh, q, pages_k, pages_v, blocks, view_ok,
                               ring_k=None, ring_v=None, ring_ok=None, *,
                               axis: str = "model") -> torch.Tensor:
    """Head-sharded :func:`flash_decode_paged`, the counterpart of the JAX
    package's ``shard_map`` of K2 (``repro/kernels/flash_decode.py:207``):
    ONE K2 launch per device of ``axis`` (``device_groups``; one per
    ``MAX_SHARDS`` shards where a device holds more), its grid over the
    head shards on that device, each walking the SAME page table over its
    own head slice of the pool and ring (the launch takes the shards'
    planes as a table). The routing inputs (``blocks``, ``view_ok``,
    ``ring_ok``) are copied to each device. q is whole: on one device (a
    virtual mesh) the launch reads it whole and its output is the result;
    on distinct cards each launch reads its shards' q heads and the outputs
    are joined on the head axis on ``mesh.lead``. The pool and ring planes
    are whole tensors or ``ShardedTensor`` pieces split on their head axis
    over ``axis`` (or whole copies).

    Both Hq and Hkv must divide the ``axis`` size (whole GQA groups per
    shard; softmax is per q-head, so no cross-shard combine). Every launch
    takes the split count of the UNSHARDED shape: K2 picks its splits from
    the (slot, KV head) clusters, so a grid over fewer heads would pick
    more and merge them in another order; with the whole call's count each
    head's result is the whole call's bit for bit. Where ``axis`` is
    missing from the mesh or has size 1 this is the lead's copy read by
    one launch. Each launch counts in ``flash_decode_paged_sharded.
    launches``. On a CPU tensor the plain version runs; on a CUDA tensor
    the kernel launches or raises."""
    from ..distributed.sharding import axis_size

    tp = axis_size(mesh, axis)
    hq, hkv = q.shape[2], pages_k.shape[-2]
    if hq % tp or hkv % tp:
        raise ValueError(
            f"flash_decode_paged_sharded: axis {axis!r} of {tp} must "
            f"divide both Hq={hq} and Hkv={hkv} (whole GQA groups per "
            f"shard); use a divisible mesh or the unsharded kernel")
    if q.device.type == "cpu":
        return flash_decode_paged_sharded_ref(
            mesh, q, pages_k, pages_v, blocks, view_ok, ring_k, ring_v,
            ring_ok, axis=axis)
    b, c, _, d = q.shape
    ps, p = pages_k.shape[-3], blocks.shape[1]
    r = 0 if ring_k is None else ring_k.shape[-3]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_split = paged_splits(sms, b, c, hq, hkv, d, p, ps, r, q.element_size())

    def read(qd, shards, blocks_d, view_ok_d, ring_ok_d):
        for pk, pv, rk, rv in shards:
            _check(qd, pk, pv, blocks_d, view_ok_d, rk, rv, ring_ok_d)
        out, launches = _paged_launch(qd, shards, blocks_d, view_ok_d,
                                      ring_ok_d, n_split)
        flash_decode_paged_sharded.launches += launches
        return out

    return _per_device(read, mesh, axis, q, pages_k, pages_v, blocks,
                       view_ok, ring_k, ring_v, ring_ok)


flash_decode_paged_sharded.launches = 0


def flash_decode_ref(
    q: torch.Tensor,        # [B, Hq, D]
    k: torch.Tensor,        # [B, T, Hkv, D]
    v: torch.Tensor,        # [B, T, Hkv, D]
    kv_mask: torch.Tensor,  # bool [B, T] valid cache slots
) -> torch.Tensor:
    """Plain PyTorch version, op for op ``ref.flash_decode_ref``: fp32
    logits, -1e30 mask, fp32 softmax cast to ``q.dtype``, then P.V."""
    b, hq, d = q.shape
    hkv = k.shape[2]
    if hkv != hq:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    logits = torch.einsum("bhd,bthd->bht", q, k).float() * (d ** -0.5)
    logits = torch.where(kv_mask.bool()[:, None, :], logits,
                         torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bht,bthd->bhd", probs, v)


# the kernel's blocks: query rows per block, at most this many splits
# (blocks) in a cluster (the portable cluster size)
BLOCK_ROWS = 16
MAX_SPLIT = 8
_SMEM_PER_SM = 228 * 1024   # an H100 SM's shared memory; 1 KB of it per block


def tile_keys(elem_size: int) -> int:
    """Keys per tile: 16 for each warp of a block, 8 warps in bf16, 4 in
    fp32 (``csrc/flash_decode.cu::Cfg``)."""
    return 128 if elem_size == 2 else 64


def smem_bytes(elem_size: int, d: int) -> int:
    """Dynamic shared memory of one block (``csrc/flash_decode.cu::Smem``).
    bf16: 3 stages of K and V tiles in 64-column swizzled boxes of 128 rows
    of 128 bytes, the 16 query rows padded by 16 bytes, a code byte per key
    of each stage, a barrier per stage, a flag, and 1 KB to align the base.
    fp32: 2 stages of 64-key tiles with rows padded by 16 bytes, the query
    rows, the codes and the flag."""
    dp = 64 if d <= 64 else 128
    tk = tile_keys(elem_size)
    if elem_size == 2:
        tile = dp // 64 * tk * 128
        return 2 * 3 * tile + 16 * (dp + 8) * 2 + 3 * tk + 8 * 3 + 16 + 1024
    stride = (dp + 4) * 4
    return 2 * 2 * tk * stride + 16 * stride + 2 * tk + 8 * 2 + 16


def _splits(sms: int, b: int, hkv: int, g: int, t: int, elem_size: int = 2,
            d: int = 128):
    """(n_split, keys per split) for a ``[B, T, Hkv, D]`` cache read by GQA
    groups of ``g`` rows on a card of ``sms`` SMs. The clusters are the
    (slot, KV head, 16 rows) triples; each takes up to 8 splits, as many as
    one wave of the card holds (the blocks that fit an SM's shared memory,
    times its SMs) over the clusters, and never more than the tiles. Each
    split is a whole number of tiles and holds at least one key. Depends on
    the shapes and the card only, so a result never depends on timing."""
    clusters = b * hkv * -(-g // BLOCK_ROWS)
    per_sm = max(1, _SMEM_PER_SM // (smem_bytes(elem_size, d) + 1024))
    tk = tile_keys(elem_size)
    tiles = -(-t // tk)
    n = max(1, min(MAX_SPLIT, per_sm * sms // clusters, tiles))
    kps = -(-tiles // n) * tk
    return -(-t // kps), kps


# K2's blocks (``csrc/flash_decode_paged.cu::Cfg``), by element size: warps
# a block, and stages of each warp's ring of 16-key chunks
PAGED_WARPS = {2: 8, 4: 4}
PAGED_STAGES = {2: 3, 4: 2}


def paged_smem_bytes(elem_size: int, d: int, c: int, g: int, p: int,
                     ps: int, r: int) -> int:
    """Dynamic shared memory of one K2 block (``csrc/flash_decode_paged.cu::
    Smem`` and ``Tables``): each warp's ring of K and V chunks of 16 keys
    (bf16 rows of 64 or 128 columns, fp32 rows padded by 16 bytes), the 16
    query rows padded by 16 bytes, a 4-byte word per key of every stage;
    then the slot's tables: the ``view_ok`` bit planes of the block's
    columns (at most ``min(C, 16, 15 // G + 2)``) and their OR, 4 bytes a
    128-key group each, the page-table row, the live-unit list, a byte per
    column and ring lane, 16 bytes of counters."""
    dp = 64 if d <= 64 else 128
    warps, stages = PAGED_WARPS[elem_size], PAGED_STAGES[elem_size]
    stride = dp + 16 // elem_size
    chunk = 16 * dp * 2 if elem_size == 2 else 16 * stride * 4
    fixed = (warps * stages * 2 * chunk + 16 * stride * elem_size
             + warps * stages * 16 * 4)
    n_words = 4 * -(-(p * ps) // 128)
    n_cg = min(c, BLOCK_ROWS, 15 // g + 2)
    colf = fixed + 4 * (n_cg + 1) * n_words + 4 * p + 4 * (p + 1)
    return ((colf + c + r + 3) & ~3) + 16


def _paged_splits(sms: int, b: int, hkv: int, rows: int, units: int,
                  keys: int, smem: int, elem_size: int = 2) -> int:
    """K2's splits per cluster for ``rows`` = C x G query rows per (slot, KV
    head) over ``units`` pages (+ the ring) of ``keys`` rows in all, on a
    card of ``sms`` SMs. The clusters are the (slot, KV head, 16 rows)
    triples; each takes up to 8 splits, as many as one wave of the card
    holds (the blocks that fit an SM's shared memory, times its SMs) over
    the clusters, never more than the units or the block-wide rounds of
    16-key chunks. Depends on the shapes and the card only, so a result
    never depends on timing."""
    clusters = b * hkv * -(-rows // BLOCK_ROWS)
    per_sm = max(1, _SMEM_PER_SM // (smem + 1024))
    rounds = -(-keys // (16 * PAGED_WARPS[elem_size]))
    return max(1, min(MAX_SPLIT, per_sm * sms // clusters, units, rounds))


def _kernel_takes(q, pages_k, pages_v, ring_k, ring_v, p: int, g: int):
    """Raises ``ValueError`` on what K2 does not take: a head_dim that is
    not a whole number of 16-byte pieces or is past 128, an empty KV set, q
    / pages / ring not contiguous or not 16-byte aligned, a block's shared
    memory past 227 KB (GQA groups of ``g``, ``p`` pages a slot)."""
    b, c, hq, d = q.shape
    ps = pages_k.shape[1]
    r = 0 if ring_k is None else ring_k.shape[1]
    es = q.element_size()
    if d % (16 // es) or d > 128:
        raise ValueError(f"head_dim {d} in {q.dtype}: the row must be a whole "
                         f"number of 16-byte pieces, at most 128 values")
    if p * ps + r == 0:
        raise ValueError("empty KV set")
    ts = [q, pages_k, pages_v] + ([ring_k, ring_v] if r else [])
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash_decode_paged needs contiguous q, pages, ring")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("q, pages and ring planes must be 16-byte aligned")
    smem = paged_smem_bytes(es, d, c, g, p, ps, r)
    if smem > 227 * 1024:
        raise ValueError(f"a block would need {smem} bytes of shared memory "
                         f"(C={c}, P={p}, ps={ps}, R={r}); at most 227 KB")


def paged_kernel_plan(q, pages_k, pages_v, blocks, ring_k, ring_v,
                      sms: int) -> int:
    """K2's ``n_split`` for these operands on a card of ``sms`` SMs
    (``_paged_splits``). Raises ``ValueError`` on what the kernel does not
    take (``_kernel_takes``)."""
    b, c, hq, d = q.shape
    ps, hkv = pages_k.shape[1], pages_k.shape[2]
    p = blocks.shape[1]
    r = 0 if ring_k is None else ring_k.shape[1]
    _kernel_takes(q, pages_k, pages_v, ring_k, ring_v, p, hq // hkv)
    return paged_splits(sms, b, c, hq, hkv, d, p, ps, r, q.element_size())


def paged_splits(sms: int, b: int, c: int, hq: int, hkv: int, d: int,
                 p: int, ps: int, r: int, elem_size: int) -> int:
    """K2's ``n_split`` from the shapes alone: ``q[b, c, hq, d]`` over ``p``
    pages of ``ps`` rows of ``hkv`` heads and a ring of ``r`` lanes."""
    smem = paged_smem_bytes(elem_size, d, c, hq // hkv, p, ps, r)
    return _paged_splits(sms, b, hkv, c * hq // hkv, p + (r > 0), p * ps + r,
                         smem, elem_size)


def kernel_plan(q, k, v, sms: int):
    """The kernel's ``(n_split, keys per split)`` for these operands on a
    card of ``sms`` SMs (``_splits``). Raises ``ValueError`` on what the
    kernel does not take: a head_dim that is not a whole number of 16-byte
    pieces or is past 128, an empty cache, operands that are not contiguous
    or not 16-byte aligned."""
    b, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    vec = 16 // q.element_size()
    if t == 0 or d % vec or d > 128:
        raise ValueError(f"head_dim {d} in {q.dtype}: the row must be a whole "
                         f"number of 16-byte pieces, at most 128 values, and "
                         f"T > 0 (T={t})")
    if not all(x.is_contiguous() for x in (q, k, v)):
        raise ValueError("flash_decode needs contiguous q, k and v")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_decode needs 16-byte aligned q, k and v")
    return _splits(sms, b, hkv, hq // hkv, t, q.element_size(), d)


def flash_decode(q, k, v, kv_mask) -> torch.Tensor:
    """One-token decode attention over a dense cache: q ``[B,Hq,D]``, k/v
    ``[B,T,Hkv,D]``, ``kv_mask`` bool ``[B,T]`` -> ``[B,Hq,D]`` in
    ``q.dtype``."""
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError("q must be [B,Hq,D] and k/v [B,T,Hkv,D]")
    b, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or v.shape != k.shape or hq % hkv:
        raise ValueError(f"bad head geometry: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if kv_mask.shape != (b, t):
        raise ValueError(f"kv_mask must be {(b, t)}, got "
                         f"{tuple(kv_mask.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if any(x.device != q.device for x in (k, v, kv_mask)):
        raise ValueError("all flash_decode operands must share a device")
    if q.device.type == "cpu":
        return flash_decode_ref(q, k, v, kv_mask)
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_decode takes float32 or bfloat16, got "
                        f"{q.dtype}")
    mask = kv_mask.to(torch.bool).contiguous()
    sms = H100_SMS if is_meta(q) else \
        torch.cuda.get_device_properties(q.device).multi_processor_count
    n_split, kps = kernel_plan(q, k, v, sms)
    out = torch.empty_like(q)
    # every key counted live: the shapes are all a meta tensor holds
    record("flash_decode", q, k4_cost, q.shape, hkv, b * t, mask.numel(),
           q.element_size())
    if is_meta(q):
        return out
    with build.on_device(q.device):
        err = build.load_library().flash_decode_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), b, hq, hkv, t, d, n_split, kps, float(d ** -0.5),
            _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err >= build.MAP_ERROR:
        raise RuntimeError(f"flash_decode: cuTensorMapEncodeTiled refused a "
                           f"tensor map (CUresult {err - build.MAP_ERROR})")
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed: CUDA error {err}")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
