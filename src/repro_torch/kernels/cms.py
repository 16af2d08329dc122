"""Port of repro/kernels/cms.py (+ ``cms_hash``/``cms_update_ref``/
``cms_query_ref`` of repro/kernels/ref.py): the count-min-sketch monitor's
hot path.

Source note
-----------
Replaces the Pallas TPU kernels ``repro/kernels/cms.py::cms_update``
(``_update_kernel``) and ``cms_query`` (``_query_kernel``). The sketch is
``counts int32[depth <= 4, 2^k]``; row ``r`` hashes an id with the
multiply-shift hash ``hash_r(x) = ((uint32)x * A_r + B_r) >> (32 - k)``.

* K5 ``cms_update``: ``counts[r, hash_r(id)] += 1`` for every id (whose
  ``mask`` is set) and every row, IN PLACE. The TPU kernel builds
  ``[block_n, width]`` one-hots and sums them so that it never scatter-adds,
  and pads the ids to its block with a "ghost" correction. Neither is carried
  over: on Hopper an integer ``atomicAdd`` is exact and independent of order,
  and the tail is masked: each (id, row) takes one global ``atomicAdd``.
* K6 ``cms_query``: ``est[i] = min_r counts[r, hash_r(ids[i])]``, one thread
  per id. It is a separate launch after K5: a query must see the counts of
  the whole batch, and the second launch is that barrier.

Bound: bytes. K5 reads the ids (and the mask) once and reads and writes
once each 32-byte sector of counters that the batch touches; K6 reads the
ids, writes the estimates and reads those sectors once (they fit L2). Both
are launch-bound at an engine batch of 4096 ids.

``k = 0`` (width 1) is a shift by 32, undefined in C++; JAX gives 0, and so
do both versions here. Negative ids are taken as their uint32 bits, as JAX's
``astype(uint32)`` does. Ids may be int32 or int64 (the low 32 bits count).

On a CPU tensor the wrappers run the plain versions; on a CUDA tensor they
launch the kernel or raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build

# Fixed odd multipliers for multiply-shift hashing (Dietzfelbinger et al.).
CMS_MULTIPLIERS = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F)
CMS_OFFSETS = (0x165667B1, 0xD3A2646D, 0xFD7046C5, 0xB55A4F09)
_MASK32 = 0xFFFFFFFF


def cms_hash(ids: torch.Tensor, row: int, log2_width: int) -> torch.Tensor:
    """int64 bucket in ``[0, 2^log2_width)`` of each id, for sketch row
    ``row``. torch has no usable uint32 multiply, so the product is taken
    mod 2^32 in int64 from two 16-bit halves of the multiplier (each partial
    product stays under 2^48)."""
    x = ids.to(torch.int64) & _MASK32
    a, b = CMS_MULTIPLIERS[row], CMS_OFFSETS[row]
    lo = x * (a & 0xFFFF)
    hi = (x * (a >> 16)) & 0xFFFF
    h = (lo + (hi << 16) + b) & _MASK32
    return h >> (32 - log2_width)


def _log2_width(counts: torch.Tensor) -> int:
    width = counts.shape[1]
    k = width.bit_length() - 1
    if width <= 0 or 1 << k != width:
        raise ValueError(f"sketch width must be a power of two, got {width}")
    return k


def cms_update_ref(counts: torch.Tensor, ids: torch.Tensor,
                   mask: Optional[torch.Tensor] = None,
                   inplace: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K5: per row, one ``index_add_`` of 1 (or of
    ``mask``) at the hashed buckets."""
    k = _log2_width(counts)
    out = counts if inplace else counts.clone()
    if mask is None:
        delta = torch.ones(ids.shape, dtype=counts.dtype, device=counts.device)
    else:
        delta = mask.to(counts.dtype)
    for r in range(counts.shape[0]):
        out[r].index_add_(0, cms_hash(ids, r, k), delta)
    return out


def cms_query_ref(counts: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K6: gather each row's bucket, min over rows."""
    k = _log2_width(counts)
    est = torch.stack([counts[r, cms_hash(ids, r, k)]
                       for r in range(counts.shape[0])])
    return est.amin(0)


def _check(counts, ids, mask=None):
    if counts.dtype != torch.int32 or counts.dim() != 2:
        raise TypeError(f"counts must be int32[depth, width], got "
                        f"{counts.dtype} {tuple(counts.shape)}")
    if not 1 <= counts.shape[0] <= len(CMS_MULTIPLIERS):
        raise ValueError(f"depth must be in [1, {len(CMS_MULTIPLIERS)}], got "
                         f"{counts.shape[0]}")
    _log2_width(counts)
    if not counts.is_contiguous():
        raise ValueError("counts must be contiguous")
    if ids.dtype not in (torch.int32, torch.int64) or ids.dim() != 1:
        raise TypeError(f"ids must be int32[n] or int64[n], got {ids.dtype} "
                        f"{tuple(ids.shape)}")
    if mask is not None and (mask.dtype != torch.bool
                             or mask.shape != ids.shape):
        raise TypeError(f"mask must be bool{list(ids.shape)}, got "
                        f"{mask.dtype} {tuple(mask.shape)}")
    for t in (ids, mask):
        if t is not None and t.device != counts.device:
            raise ValueError("all cms operands must share a device")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def cms_update(counts: torch.Tensor, ids: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K5: add every id (where ``mask``) to the sketch, IN PLACE on
    ``counts`` (returned). ``n = 0`` leaves it as it is and launches
    nothing."""
    _check(counts, ids, mask)
    if counts.device.type == "cpu":
        return cms_update_ref(counts, ids, mask, inplace=True)
    n = ids.shape[0]
    if n == 0:
        return counts
    ids = ids.contiguous()
    with build.on_device(counts.device):
        err = build.load_library().cms_update_launch(
            counts.data_ptr(), ids.data_ptr(), ids.element_size(),
            0 if mask is None else mask.contiguous().data_ptr(), n,
            counts.shape[0], _log2_width(counts), _stream(counts))
    if err != 0:
        raise RuntimeError(f"cms_update launch failed: CUDA error {err}")
    cms_update.launches += 1
    return counts


def cms_query(counts: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """K6: ``int32[n]`` count-min estimate of each id."""
    _check(counts, ids)
    if counts.device.type == "cpu":
        return cms_query_ref(counts, ids)
    n = ids.shape[0]
    out = torch.empty((n,), dtype=torch.int32, device=counts.device)
    if n == 0:
        return out
    ids = ids.contiguous()
    with build.on_device(counts.device):
        err = build.load_library().cms_query_launch(
            counts.data_ptr(), ids.data_ptr(), ids.element_size(),
            out.data_ptr(), n, counts.shape[0], _log2_width(counts),
            _stream(counts))
    if err != 0:
        raise RuntimeError(f"cms_query launch failed: CUDA error {err}")
    cms_query.launches += 1
    return out


cms_update.launches = 0
cms_query.launches = 0
