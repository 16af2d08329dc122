"""Port of repro/launch/roofline.py: the roofline of a dry-run cell, counted
on the ``meta`` device.

Hardware model: one NVIDIA H100 SXM per mesh device, at its published
peaks (NVIDIA's data sheet, dense, 700 W power limit; ``kernels.cost``):
989 TFLOP/s bf16, 67 TFLOP/s fp32 (no TF32: the port keeps ``allow_tf32``
off), 3.35 TB/s HBM3, 80 GB. Per (arch x shape) on the single-pod mesh:

    compute_s    = sum over dtypes of the slowest device's products in
                   that dtype / its peak (the fp32 vocab head at 67e12,
                   the bf16 trunk at 989e12)
    memory_s     = the slowest device's bytes / 3.35e12
    collective_s = sum over mesh axes of collective bytes / that axis' link

Links. A node is 8 GPUs joined by NVLink 4 (450 GB/s a direction a GPU,
NVIDIA's data sheet); nodes talk through one 400 Gb/s ConnectX-7 NIC a GPU
(50 GB/s a direction). Mesh devices are numbered row-major over the mesh
axes and fill the nodes in order, so an axis stays on NVLink only when each
of its groups lies inside one node (its stride times its size divides 8).
On the production meshes (16 x 16 and 2 x 16 x 16) every axis crosses
nodes, ``model`` (16 wide) too: all their collectives go at 50 GB/s. A
collective over several axes goes at its slowest axis' link.

Counting (``count_step``): one meta run of the cell's step under
:class:`CountMode` and the collectives' counters:

* FLOPs: each matrix product (``torch.utils.flop_counter``'s formulas, as
  ``FlopCounterMode`` counts them: products only, where XLA's
  ``cost_analysis`` counts every op) by the dtype of its operands, plus the
  hand-written kernels' own operations (``kernels.cost``, recorded by the
  wrappers' meta branch) in their inputs' dtype;
* bytes: each aten op's input and output bytes (views and uninitialised
  allocations free; an in-place row update such as ``index_put_`` its
  operands read and as many written, not its whole destination) plus the
  kernels' bytes: what the eager port moves, with no fusion;
* collectives: ``distributed.collectives``' counters, bytes by op and axes
  (the ring algorithm's bytes arriving at the members).

Device by device: the step runs every virtual rank in turn, so each op is
counted to the rank whose tensors it reads. The pieces of the arguments'
sharded tensors and every collective's outputs carry their rank; an op's
outputs take the rank of its inputs (a ``_foreach_`` op's, list entry by
list entry). An op that reads no ranked tensor or several ranks', and the
sums and copies that stand in for a collective's transfers
(``collectives.emulating``), are unattributed and shared evenly. The
metrics keep the mean a device (JAX's per-device count) and the slowest
device's (``flops_rank_max:<dtype>``, ``bytes_rank_max``), which the terms
take: a padded head, the vocab's last lanes or the MoE's capacity buffer
would show there. :func:`rank_balance` gives the max over the mean.

:class:`CountMode` also keeps the live bytes of the storages the step
makes and frees (each rounded up to 512 bytes, as the CUDA caching
allocator rounds) and their peak: the step's transient memory.

Depth: the per-rank Python step runs every rank of every layer, so probes
stay at depth 1-2 and the full depth is reconstructed affinely:

    cost(L) = base + marginal * L        (marginal from depth-1/depth-2)
    train:  cost(L, M) = opt(L) + M * micro(L); opt scaled by param ratio.

The transient peak is not summed over microbatches: it is the two-
microbatch probe's (gradient accumulator and one microbatch's activations)
plus the depth marginal.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..configs.base import ModelConfig, ShapeSpec
from ..distributed import collectives
from ..distributed.collectives import collective_bytes, reset_collective_counts
from ..distributed.sharding import ShardedTensor
from ..kernels import cost as K
from . import cells as C

PEAK_FLOPS = K.PEAK_FLOPS[torch.bfloat16]   # bf16 / GPU
HBM_BW = K.HBM_BYTES_PER_S                  # B/s
NVLINK_BW = 450e9       # B/s a direction a GPU, NVLink 4
NET_BW = 50e9           # B/s a direction a GPU, one 400 Gb/s ConnectX-7
NODE_GPUS = 8           # GPUs a node share NVLink
ALLOC_ROUND = 512       # the CUDA caching allocator's block granularity
SINGLE_POD = {"data": 16, "model": 16}
# the dtypes products are priced in, by the name their metrics carry
DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "fp32"}
PEAK_BY_NAME = {n: K.PEAK_FLOPS[d] for d, n in DTYPE_NAMES.items()}

_A = torch.ops.aten
# allocations that touch no memory
_NO_TRAFFIC = {_A.empty.memory_format, _A.empty_like.default,
               _A.empty_strided.default, _A.empty_permuted.default}
# in-place updates of some rows of their first argument: they move the
# rows they write (their other operands' worth), not the whole destination
_ROW_UPDATES = {getattr(getattr(_A, n), o)
                for n in ("index_put_", "_index_put_impl_", "index_copy_",
                          "index_add_", "scatter_", "scatter_add_",
                          "masked_scatter_")
                for o in getattr(_A, n).overloads()}


def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dtype_name(dtype) -> str:
    return DTYPE_NAMES.get(dtype, str(dtype).replace("torch.", ""))


def _device_tensors(tree):
    """The tensors of ``tree`` on the step's device (a checkpoint's saved
    CPU RNG state and other host tensors are free)."""
    return [t for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor) and t.device.type != "cpu"]


class CountMode(TorchDispatchMode):
    """Counts a step's products by (rank, dtype) (``flops``), its bytes by
    rank (``bytes``; rank ``None``: unattributed) and the storages its ops
    make and free: ``live`` bytes now and their ``peak`` since entry, each
    storage rounded up to ``ALLOC_ROUND``; a storage made before entry
    lowers ``live`` when it is freed. Ranks come from :meth:`tag` (the
    arguments' pieces, each collective's outputs) and flow from each op's
    inputs to its outputs."""

    def __init__(self):
        super().__init__()
        self.flops: Dict[tuple, int] = defaultdict(int)
        self.bytes: Dict[Optional[int], int] = defaultdict(int)
        self.live = 0
        self.peak = 0
        self._seen: "weakref.WeakSet" = weakref.WeakSet()
        self._rank: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self._parts = 0     # > 0 inside a composite op's decomposition

    def tag(self, xs) -> None:
        """Entry ``r`` of ``xs`` (one tensor a device) holds rank ``r``'s
        values; a storage that sits at several entries holds none's."""
        ranks: Dict[Any, Optional[int]] = {}
        for r, t in enumerate(xs):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                ranks[st] = r if ranks.get(st, r) == r else None
        for st, r in ranks.items():
            if r is None:
                self._rank.pop(st, None)
            else:
                self._rank[st] = r

    def rank_of(self, tensors) -> Optional[int]:
        """The one rank whose tensors ``tensors`` read (None: none or
        several)."""
        found = None
        for t in tensors:
            r = self._rank.get(t.untyped_storage())
            if r is not None:
                if found is not None and r != found:
                    return None
                found = r
        return found

    def kernel(self, x: torch.Tensor, flops: int, nbytes: int) -> None:
        """A hand-written kernel's call on ``x`` (``KernelCounter``'s
        observer)."""
        r = self.rank_of([x])
        self.flops[(r, _dtype_name(x.dtype))] += flops
        self.bytes[r] += nbytes

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def _track(self, t: torch.Tensor, new: bool, rank) -> None:
        st = t.untyped_storage()
        if rank is not None and st not in self._rank:
            self._rank[st] = rank
        if st in self._seen:
            return
        self._seen.add(st)
        nbytes = -(-st.nbytes() // ALLOC_ROUND) * ALLOC_ROUND
        if new:
            self.live += nbytes
            self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, nbytes)

    def _op_bytes(self, func, ins, outs) -> int:
        if func in _ROW_UPDATES:
            # the operands read, and as many bytes written
            return 2 * sum(_tensor_bytes(t) for t in ins[1:])
        if func.is_view or func in _NO_TRAFFIC:
            return 0
        return sum(_tensor_bytes(t) for t in ins + outs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        out = NotImplemented
        if packet not in flop_registry and \
                func is not torch.ops.prim.device.default:
            # as FlopCounterMode: a composite op's products are its parts'
            self._parts += 1
            try:
                with self:
                    out = func.decompose(*args, **kwargs)
            finally:
                self._parts -= 1
        if out is NotImplemented:
            out = func(*args, **kwargs)
        ins, outs = _device_tensors((args, kwargs)), _device_tensors(out)
        # a collective's stand-in sums and copies are no rank's own work
        rank = None if collectives.emulating() else self.rank_of(ins)
        if packet in flop_registry:
            dtype = _dtype_name(next(
                t for t in tree_flatten(args)[0]
                if isinstance(t, torch.Tensor)).dtype)
            self.flops[(rank, dtype)] += flop_registry[packet](
                *args, **kwargs, out_val=out)
        if self._parts:
            return out      # the composite op's bytes are counted whole
        if packet.__name__.startswith("_foreach_"):
            # entry by entry of its lists, each entry its own rank's
            lists = [a for a in args if isinstance(a, (list, tuple))]
            outl = list(out) if isinstance(out, (list, tuple)) else []
            for i in range(len(lists[0]) if lists else 0):
                e_in = _device_tensors([a[i] for a in lists])
                e_out = _device_tensors(outl[i:i + 1])
                r = self.rank_of(e_in)
                for t in e_in:
                    self._track(t, False, None)
                for t in e_out:
                    self._track(t, True, r)
                self.bytes[r] += self._op_bytes(func, e_in, e_out)
            return out
        for t in ins:
            self._track(t, False, None)
        for t in outs:
            self._track(t, True, rank)
        self.bytes[rank] += self._op_bytes(func, ins, outs)
        return out


def _ranked_pieces(obj, n: int, out: list) -> None:
    """Every list of ``n`` tensors (a sharded value, one piece a device)
    and every ``ShardedTensor``'s pieces in ``obj``'s dicts, lists, tuples
    and dataclasses (not modules)."""
    if isinstance(obj, ShardedTensor):
        obj = obj.shards
    if isinstance(obj, (list, tuple)) and len(obj) == n and \
            all(isinstance(t, torch.Tensor) for t in obj):
        out.append(obj)
    elif isinstance(obj, dict):
        for v in obj.values():
            _ranked_pieces(v, n, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _ranked_pieces(v, n, out)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _ranked_pieces(getattr(obj, f.name), n, out)


def count_step(step, args, n_devices: int):
    """One run of ``step(*args)`` under the counters -> (per-device
    metrics, the kernels' launches by kernel, would-be on ``meta``, totals
    over the ranks). Metrics: the mean a device of ``flops``, each dtype's
    ``flops:<dtype>``, ``bytes``, ``coll_bytes`` and ``coll_<op>:<axes>``,
    the transient ``peak_bytes``; the slowest device's products by dtype
    (``flops_rank_max:<dtype>``, slowest at the dtypes' peaks) and its
    ``bytes_rank_max``, each with the unattributed share spread evenly; the
    unattributed ``flops_unattributed`` / ``bytes_unattributed`` a
    device."""
    reset_collective_counts()
    cm = CountMode()
    pieces: list = []
    _ranked_pieces(args, n_devices, pieces)
    for xs in pieces:
        cm.tag(xs)
    collectives.OUTPUT_OBSERVERS.append(cm.tag)
    try:
        with K.KernelCounter(observer=cm.kernel) as kc, cm:
            out = step(*args)
            del out
    finally:
        collectives.OUTPUT_OBSERVERS.remove(cm.tag)
    coll = collective_bytes()
    reset_collective_counts()
    n = float(n_devices)
    dtypes = sorted({d for _, d in cm.flops})
    shared = {d: cm.flops.get((None, d), 0) / n for d in dtypes}

    def rank_flops(r):
        return {d: cm.flops.get((r, d), 0) + shared[d] for d in dtypes}
    slowest = max((rank_flops(r) for r in range(n_devices)),
                  key=lambda f: compute_seconds(
                      {"flops": 0.0, **{f"flops:{d}": v
                                        for d, v in f.items()}}),
                  default={})
    metrics = {
        "flops": sum(cm.flops.values()) / n,
        "bytes": sum(cm.bytes.values()) / n,
        "coll_bytes": sum(coll.values()) / n,
        "peak_bytes": cm.peak / n,
        "bytes_rank_max": max(cm.bytes.get(r, 0) for r in range(n_devices))
        + cm.bytes.get(None, 0) / n,
        "flops_unattributed": sum(shared.values()),
        "bytes_unattributed": cm.bytes.get(None, 0) / n,
        **{f"flops:{d}": sum(v for (_, dd), v in cm.flops.items()
                             if dd == d) / n for d in dtypes},
        **{f"flops_rank_max:{d}": v for d, v in slowest.items()},
        **{f"coll_{k}": v / n for k, v in coll.items()},
    }
    return metrics, kc.launches()


def compute_seconds(metrics: Dict[str, float],
                    prefix: str = "flops:") -> float:
    """The products under ``<prefix><dtype>`` keys, each dtype at its peak
    (``metrics["flops"]`` at the bf16 peak where no key has a dtype, as
    JAX's metrics)."""
    keyed = {k[len(prefix):]: v for k, v in metrics.items()
             if k.startswith(prefix)}
    if not keyed:
        return metrics["flops"] / PEAK_FLOPS
    unknown = set(keyed) - set(PEAK_BY_NAME)
    if unknown:
        raise ValueError(f"no peak for products in {sorted(unknown)}")
    return sum(v / PEAK_BY_NAME[d] for d, v in keyed.items())


def rank_balance(metrics: Dict[str, float]) -> Dict[str, float]:
    """The slowest device over the mean, in products and bytes, and the
    unattributed share of each."""
    flops = metrics["flops"] or 1.0
    nbytes = metrics["bytes"] or 1.0
    return {
        "flops_max_over_mean": sum(
            v for k, v in metrics.items()
            if k.startswith("flops_rank_max:")) / flops,
        "bytes_max_over_mean": metrics["bytes_rank_max"] / nbytes,
        "flops_unattributed_share": metrics["flops_unattributed"] / flops,
        "bytes_unattributed_share": metrics["bytes_unattributed"] / nbytes,
    }


def _combine(a: Dict[str, float], b: Dict[str, float], fa: float, fb: float):
    keys = set(a) | set(b)
    return {k: fa * a.get(k, 0.0) + fb * b.get(k, 0.0) for k in keys}


# ---------------------------------------------------------------------------
# Probing
# ---------------------------------------------------------------------------


def _lower_metrics(cfg, shape, mesh, *, microbatches=None,
                   dispatch_mode="staged") -> Dict[str, float]:
    step, args, _meta = C.build_cell(cfg, shape, mesh,
                                     microbatches=microbatches,
                                     dispatch_mode=dispatch_mode)
    return count_step(step, args, len(mesh.devices))[0]


def _peak(m: Dict[str, float]) -> float:
    return m.pop("peak_bytes")


def probe_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
               dispatch_mode: str = "staged") -> Dict[str, float]:
    """Affine-extrapolated per-device metrics for the FULL-depth cell, and
    its transient ``peak_bytes``."""
    probes = C.depth_probes(cfg)

    def lower(c, s, mb=None):
        return _lower_metrics(c, s, mesh, microbatches=mb,
                              dispatch_mode=dispatch_mode)

    if shape.step == "train":
        mb = C.TRAIN_MICROBATCHES.get(cfg.name, C.TRAIN_MICROBATCHES["default"])
        micro_bs = shape.global_batch // mb
        micro_shape = dataclasses.replace(shape, global_batch=micro_bs)
        two_shape = dataclasses.replace(shape, global_batch=2 * micro_bs)

        if cfg.family == "encdec":
            c11 = C.probe_config(cfg, probes[0][1])
            c21 = C.probe_config(cfg, probes[1][1])
            c12 = C.probe_config(cfg, probes[2][1])
            p11 = lower(c11, micro_shape, 1)
            p21 = lower(c21, micro_shape, 1)
            p12 = lower(c12, micro_shape, 1)
            pm2 = lower(c11, two_shape, 2)
            pk11, pk21, pk12, pkm2 = map(_peak, (p11, p21, p12, pm2))
            micro_11 = _combine(pm2, p11, 1.0, -1.0)   # one extra microbatch
            opt_11 = _combine(p11, micro_11, 1.0, -1.0)
            mu_dec = _combine(p21, p11, 1.0, -1.0)
            mu_enc = _combine(p12, p11, 1.0, -1.0)
            ld, le = cfg.n_layers, cfg.n_enc_layers
            micro_l = _combine(
                _combine(micro_11, mu_dec, 1.0, float(ld - 1)),
                mu_enc, 1.0, float(le - 1),
            )
            ratio = cfg.param_count() / c11.param_count()
            opt_l = {k: v * ratio for k, v in opt_11.items()}
            out = _combine(opt_l, micro_l, 1.0, float(mb))
            out["peak_bytes"] = (pkm2 + (ld - 1) * (pk21 - pk11)
                                 + (le - 1) * (pk12 - pk11))
            return out

        d1_cfg = C.probe_config(cfg, probes[0][1])
        d2_cfg = C.probe_config(cfg, probes[1][1])
        p11 = lower(d1_cfg, micro_shape, 1)
        p21 = lower(d2_cfg, micro_shape, 1)
        p12 = lower(d1_cfg, two_shape, 2)
        pk11, pk21, pk12 = map(_peak, (p11, p21, p12))
        micro_1 = _combine(p12, p11, 1.0, -1.0)   # one more microbatch @d1
        opt_1 = _combine(p11, micro_1, 1.0, -1.0)
        mu = _combine(p21, p11, 1.0, -1.0)        # per-depth-unit marginal
        units = C.full_depth_units(cfg)
        micro_l = _combine(micro_1, mu, 1.0, float(units - 1))
        ratio = cfg.param_count() / d1_cfg.param_count()
        opt_l = {k: v * ratio for k, v in opt_1.items()}
        out = _combine(opt_l, micro_l, 1.0, float(mb))
        out["peak_bytes"] = pk12 + (units - 1) * (pk21 - pk11)
        return out

    # prefill / decode: cost(L) = p1 + (L-1) * (p2 - p1), the peak too
    if cfg.family == "encdec" and shape.step == "prefill":
        c11 = C.probe_config(cfg, probes[0][1])
        c21 = C.probe_config(cfg, probes[1][1])
        c12 = C.probe_config(cfg, probes[2][1])
        p11, p21, p12 = lower(c11, shape), lower(c21, shape), lower(c12, shape)
        mu_dec = _combine(p21, p11, 1.0, -1.0)
        mu_enc = _combine(p12, p11, 1.0, -1.0)
        return _combine(
            _combine(p11, mu_dec, 1.0, float(cfg.n_layers - 1)),
            mu_enc, 1.0, float(cfg.n_enc_layers - 1),
        )

    d1_cfg = C.probe_config(cfg, probes[0][1])
    d2_cfg = C.probe_config(cfg, probes[1][1])
    p1, p2 = lower(d1_cfg, shape), lower(d2_cfg, shape)
    units = C.full_depth_units(cfg)
    if isinstance(units, tuple):
        # enc-dec decode: the encoder does not run in decode_step — only
        # the decoder depth scales (probes 0/1 vary decoder layers).
        units = units[0]
    mu = _combine(p2, p1, 1.0, -1.0)
    return _combine(p1, mu, 1.0, float(units - 1))


# ---------------------------------------------------------------------------
# Terms
# ---------------------------------------------------------------------------


def axis_bandwidth(mesh_shape: Dict[str, int], axes) -> float:
    """The link rate (B/s a direction a GPU) of a collective over ``axes``
    on a mesh of ``mesh_shape`` (axis -> size, row-major): NVLink where
    every group lies inside one node of ``NODE_GPUS``, else the network."""
    names = list(mesh_shape)
    for a in axes:
        stride = 1
        for b in names[names.index(a) + 1:]:
            stride *= mesh_shape[b]
        if NODE_GPUS % (stride * mesh_shape[a]):
            return NET_BW
    return NVLINK_BW


def collective_seconds(metrics: Dict[str, float],
                       mesh_shape: Dict[str, int]) -> float:
    """Per-device collective time: each ``coll_<op>:<axes>`` byte count at
    its axes' link."""
    total = 0.0
    for k, v in metrics.items():
        if k.startswith("coll_") and ":" in k:
            axes = k.split(":", 1)[1].split("+")
            total += v / axis_bandwidth(mesh_shape, axes)
    return total


def roofline_terms(metrics: Dict[str, float], cfg: ModelConfig,
                   shape: ShapeSpec,
                   mesh_shape: Optional[Dict[str, int]] = None
                   ) -> Dict[str, Any]:
    mesh_shape = mesh_shape or SINGLE_POD
    n_dev = 1
    for v in mesh_shape.values():
        n_dev *= v
    # the slowest device's where the metrics have it, else the mean's
    slowest = any(k.startswith("flops_rank_max:") for k in metrics)
    compute_s = compute_seconds(
        metrics, "flops_rank_max:" if slowest else "flops:")
    memory_s = metrics.get("bytes_rank_max", metrics["bytes"]) / HBM_BW
    coll_s = collective_seconds(metrics, mesh_shape)
    dominant = max(
        ("compute", compute_s), ("memory", memory_s), ("collective", coll_s),
        key=lambda kv: kv[1],
    )[0]
    # MODEL_FLOPS: 6·N·D (dense) / 6·N_active·D (MoE); D = tokens processed.
    if shape.step == "train":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 6 * cfg.active_param_count() * tokens
    elif shape.step == "prefill":
        tokens = shape.global_batch * C.prefill_chunk(cfg, shape)
        model_flops = 2 * cfg.active_param_count() * tokens
    else:  # decode: one token per sequence
        tokens = shape.global_batch
        model_flops = 2 * cfg.active_param_count() * tokens
    model_flops_per_dev = model_flops / n_dev
    useful = model_flops_per_dev / metrics["flops"] if metrics["flops"] else 0.0
    bound = max(compute_s, memory_s, coll_s)
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": coll_s,
        "dominant": dominant,
        "model_flops_ratio": useful,
        "roofline_fraction": (compute_s / bound) if bound else 0.0,
        "flops_per_dev": metrics["flops"],
        "bytes_per_dev": metrics["bytes"],
        "coll_bytes_per_dev": metrics["coll_bytes"],
    }


__all__ = ["ALLOC_ROUND", "CountMode", "DTYPE_NAMES", "HBM_BW", "NET_BW",
           "NODE_GPUS", "NVLINK_BW", "PEAK_BY_NAME", "PEAK_FLOPS",
           "SINGLE_POD", "axis_bandwidth", "collective_seconds",
           "compute_seconds", "count_step", "probe_cell", "rank_balance",
           "roofline_terms"]
