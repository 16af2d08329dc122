"""What a kernel costs, from its shapes: the card's peaks, each kernel's
operations and bytes, and the counter the meta device counts them in.

One formula gives both the kernel table's ``bound_ms`` (``chip_smoke.py``,
on this run's inputs) and a dry-run cell's roofline (``launch.roofline``,
on the ``meta`` device). Bytes count each input read once and each output
written once; operations count the products the function needs (two a
multiply-add). Where the work depends on the data (the live rows of a
drain, the live keys of a decode read) the caller passes what it knows: the
kernel table the count of this run's data, a wrapper the count the shapes
allow (every row valid, every key live), which is all a meta tensor holds.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W power
limit): 989 TFLOP/s in bf16, 67 TFLOP/s in fp32 outside the tensor cores
(the port keeps ``allow_tf32`` off), 3.35 TB/s of HBM3, 80 GB.

:class:`KernelCounter` records, while it is active, each wrapper call that
launches a kernel on a CUDA tensor or would launch it on a ``meta`` one:
its would-be launches, operations and bytes under the kernel's name. It is
apart from ``wrapper.launches``, which counts real launches only.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES = 80e9
# its SMs: a stand-in where a meta call checks a launch plan it never runs
H100_SMS = 132


def _tri(n: int) -> int:
    """1 + 2 + ... + n (0 for n <= 0)."""
    return n * (n + 1) // 2 if n > 0 else 0


def live_pairs(s: int, t: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask lets through, per head: ``s`` queries at
    the end of ``t`` keys (query ``q`` at position ``t - s .. t - 1``),
    causal or not, a sliding ``window`` (0: none). Query ``q`` sees
    ``max(q + 1, 0)`` keys causally, ``t`` otherwise, less the
    ``max(q + 1 - window, 0)`` the window drops: sums of arithmetic
    series."""
    def clipped(c):    # sum over q of max(q + c, 0)
        return _tri(t - 1 + c) - _tri(t - s - 1 + c)
    seen = clipped(1) if causal else s * t
    return seen - (clipped(1 - window) if window > 0 else 0)


def bound_ms(flops: float, nbytes: float, dtype) -> Tuple[float, str]:
    """The least time on the card for ``flops`` operations in ``dtype`` and
    ``nbytes`` of HBM traffic, and which of the two sets it."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def k3_cost(q_shape, k_shape, elem: int, causal: bool, window: int,
            lse: bool = False) -> Tuple[int, int]:
    """K3 forward (``flash_attention``): ``4 * D * Hq * B * live pairs``
    operations; q, k and v read and the output written once (and the fp32
    ``[B, Hq, S]`` log-sum-exp written where it is asked for)."""
    b, hq, s, d = q_shape
    kv = b * k_shape[1] * k_shape[2] * k_shape[3]
    flops = 4 * d * hq * b * live_pairs(s, k_shape[2], causal, window)
    nbytes = (2 * b * hq * s * d + 2 * kv) * elem + (4 * b * hq * s
                                                     if lse else 0)
    return flops, nbytes


def k3_bwd_cost(q_shape, k_shape, elem: int, causal: bool,
                window: int) -> Tuple[int, int]:
    """K3's backward (``flash_attention_bwd``): ``10 * D * Hq * B * live
    pairs`` operations; q, out and dout read and dq written, k and v read
    and dk and dv written, the fp32 lse read."""
    b, hq, s, d = q_shape
    kv = b * k_shape[1] * k_shape[2] * k_shape[3]
    flops = 10 * d * hq * b * live_pairs(s, k_shape[2], causal, window)
    nbytes = (4 * b * hq * s * d + 4 * kv) * elem + 4 * b * hq * s
    return flops, nbytes


def k1_cost(n_valid: int, n: int, w: int, elem: int, idx_elem: int,
            planes: int = 1) -> Tuple[int, int]:
    """K1's drain (``staged_scatter`` / ``staged_drain``) over ``planes``
    planes of width ``w`` (a plane of L layers counts L) sharing one
    routing list: each valid staged row of each plane read and written,
    the routing (``n`` indices and ``n`` bools) read once; no
    operations."""
    return 0, 2 * n_valid * w * elem * planes + n * (idx_elem + 1)


def k1_gather_cost(n_valid: int, n: int, w: int, elem: int,
                   idx_elem: int) -> Tuple[int, int]:
    """The drain's adjoint (``staged_gather``): the valid rows read, every
    one of the ``n`` output rows written, the routing read."""
    return 0, (n_valid + n) * w * elem + n * (idx_elem + 1)


def k4_cost(q_shape, hkv: int, n_live: int, mask_numel: int,
            elem: int) -> Tuple[int, int]:
    """K4 (``flash_decode``): ``4 * Hq * live keys * D`` operations; the
    live keys' K and V rows, q in and out, the mask read once."""
    b, hq, d = q_shape
    return (4 * hq * n_live * d,
            n_live * hkv * d * 2 * elem + 2 * b * hq * d * elem + mask_numel)


class KernelCounter:
    """While active (``with KernelCounter() as kc:``), every wrapper call
    that launches or would launch a kernel adds here: ``counts[name] =
    {"launches", "flops", "bytes"}``. Counters nest; each active one
    records. ``observer``, where given, is also called as ``observer(x,
    flops, nbytes)`` for each call, ``x`` the tensor the kernel runs on
    (``launch.roofline`` prices the operations in ``x``'s dtype and counts
    the call to ``x``'s rank)."""

    def __init__(self, observer: Optional[Callable] = None):
        self.counts: Dict[str, Dict[str, int]] = {}
        self.observer = observer

    def add(self, name: str, x: torch.Tensor, flops: int,
            nbytes: int) -> None:
        c = self.counts.setdefault(name, dict(launches=0, flops=0, bytes=0))
        c["launches"] += 1
        c["flops"] += int(flops)
        c["bytes"] += int(nbytes)
        if self.observer is not None:
            self.observer(x, int(flops), int(nbytes))

    def total(self, key: str) -> int:
        return sum(c[key] for c in self.counts.values())

    def launches(self) -> Dict[str, int]:
        return {k: c["launches"] for k, c in self.counts.items()}

    def __enter__(self) -> "KernelCounter":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)


_ACTIVE: List[KernelCounter] = []


def record(name: str, x: torch.Tensor, cost_fn, *args) -> None:
    """One call of kernel ``name`` on ``x`` (the tensor whose dtype its
    operations run in), launched or (on ``meta``) not: its ``(flops,
    bytes) = cost_fn(*args)`` added to every active :class:`KernelCounter`
    (worked out only while one is active, so a launch on the card pays
    nothing for it otherwise)."""
    if _ACTIVE:
        flops, nbytes = cost_fn(*args)
        for c in _ACTIVE:
            c.add(name, x, flops, nbytes)


def is_meta(t: torch.Tensor) -> bool:
    """A ``meta`` tensor: shapes and counts, never a value."""
    return t.device.type == "meta"


__all__ = ["H100_SMS", "HBM_BYTES", "HBM_BYTES_PER_S", "KernelCounter",
           "PEAK_FLOPS", "bound_ms", "is_meta", "k1_cost", "k1_gather_cost",
           "k3_bwd_cost", "k3_cost", "k4_cost", "live_pairs", "record"]
