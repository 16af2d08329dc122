"""Port of repro/kernels/staged_scatter.py (+ ``staged_scatter_ref`` of
repro/kernels/ref.py): the unload path's drain.

Source note
-----------
Replaces the Pallas TPU kernel ``repro/kernels/staged_scatter.py::
staged_scatter`` (``_drain_kernel``). It computes
``dest[dst_row[i]] = staging[i]`` where ``valid[i]``, in place; valid rows
are unique within one drain. The TPU version has an unpredicated body and a
wrapper that sorts valid entries first and duplicates the last valid write
into the tail; on Hopper a per-row predicate read by the block is free.
Bound: bytes, ``2 * n_valid * W * elemsize`` a plane and layer, plus the
routing (``N`` indices and ``N`` bools). ``csrc/staged_scatter.cu`` drains
a TABLE of planes over one shared routing list in one launch: the K and V
planes of the paged pool, and every head shard of them on one device
(``staged_scatter_planes``; ``staged_scatter`` and
``staged_scatter_layers`` are tables of one). The routing is read as the
caller holds it (int32 or int64 rows, bool valid, any stride): on a CUDA
tensor the wrappers make no conversion and no copy, and raise on another
dtype. The table goes to the kernel by value; one block per (staged entry,
8 layers, plane) loads the predicate and the row together and, for a live
in-range entry only, keeps up to 16 16-byte loads a thread in flight
before its stores, the block sized to the widest row.

Training's staged MoE dispatch drains through ``staged_drain``, the
functional form (a fresh zero buffer, one K1 launch) under autograd. Its
backward is the adjoint ``staged_gather``, ``grad_staging[i] =
grad_dest[dst_row[i]]`` for a valid, in-range entry, else zeros: a row
gather over the same routing list in one launch
(``csrc/staged_scatter.cu::gather_rows_kernel``). It replaces no TPU kernel
(the JAX package takes that gradient by autodiff of ``.at[].set``); bound:
bytes, the valid rows read and every output row written once, plus the
routing.

On a CPU tensor the wrappers run the plain version; on a CUDA tensor they
launch the kernel or raise; on a ``meta`` tensor they make the outputs,
skip the launch and add the kernel's cost (``cost.k1_cost`` summed over a
table's planes, ``cost.k1_gather_cost``; every staged row counted valid:
the shapes are all a meta tensor holds) to the active
``KernelCounter``.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import build
from .cost import is_meta, k1_cost, k1_gather_cost, record

# planes one launch takes (``csrc/staged_scatter.cu::kMaxPlanes``): the K
# and V planes of 16 head shards, as K2s reads 16 shards a launch
# (``flash_decode.MAX_SHARDS``); a larger table launches once per this many
MAX_PLANES = 32
_INDEX_DTYPES = (torch.int32, torch.int64)

Plane = Tuple[torch.Tensor, torch.Tensor]


def staged_scatter_ref(
    dest: torch.Tensor,     # [R, W] destination memory (pages/buffers)
    staging: torch.Tensor,  # [N, W] staging ring payloads (append order)
    dst_row: torch.Tensor,  # int[N] destination row per staged entry
    valid: torch.Tensor,    # bool[N] live entries
    inplace: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version. PRECONDITION: valid ``dst_row`` entries are
    unique (a conflicting incoming write forces a drain first). Entries that
    are not valid, or whose row lies outside ``[0, R)``, are dropped."""
    keep = valid.bool() & (dst_row >= 0) & (dst_row < dest.shape[0])
    out = dest if inplace else dest.clone()
    out.index_copy_(0, dst_row[keep].long(), staging[keep].to(dest.dtype))
    return out


def staged_scatter_planes_ref(planes: Sequence[Plane], dst_row: torch.Tensor,
                              valid: torch.Tensor) -> None:
    """Plain version of a table entry: ``staged_scatter_ref`` over every
    layer of every ``(dest [L, R, W], staging [L, N, W])`` plane, in place.
    The wrappers run it on CPU tensors only."""
    for dest, staging in planes:
        for l in range(dest.shape[0]):
            staged_scatter_ref(dest[l], staging[l], dst_row, valid,
                               inplace=True)


def _check(dest, staging, dst_row, valid, lead):
    if dest.dtype != staging.dtype:
        raise TypeError(
            f"staged_scatter copies bytes: dest {dest.dtype} != staging "
            f"{staging.dtype}")
    if dest.element_size() not in (2, 4):
        raise TypeError(f"staged_scatter takes 2- or 4-byte elements, got "
                        f"{dest.dtype}")
    if dest.dim() != lead + 2 or staging.dim() != lead + 2:
        raise ValueError(f"expected {lead + 2}-d dest and staging, got "
                         f"{tuple(dest.shape)} and {tuple(staging.shape)}")
    if dest.shape[-1] != staging.shape[-1] or (
            lead and dest.shape[0] != staging.shape[0]):
        raise ValueError(f"shape mismatch: dest {tuple(dest.shape)}, staging "
                         f"{tuple(staging.shape)}")
    n = staging.shape[-2]
    if dst_row.shape != (n,) or valid.shape != (n,):
        raise ValueError(f"dst_row/valid must be [{n}], got "
                         f"{tuple(dst_row.shape)} / {tuple(valid.shape)}")
    if staging.stride(-1) != 1 or staging.stride(-2) != staging.shape[-1] \
            or dest.stride(-1) != 1 or dest.stride(-2) != dest.shape[-1]:
        raise ValueError("staged_scatter needs row-contiguous dest and staging")
    for t in (staging, dst_row, valid):
        if t.device != dest.device:
            raise ValueError("all staged_scatter operands must share a device")


def _table_cost(planes, dst_row):
    """One launch's cost: its planes' rows (a plane of L layers counts L),
    each staged row counted valid, and the routing once."""
    n, idx = dst_row.shape[0], dst_row.element_size()
    return 0, sum(k1_cost(n, 0 if j else n, d.shape[-1], d.element_size(),
                          idx, planes=d.shape[0])[1]
                  for j, (d, _) in enumerate(planes))


def _launch(name, planes, dst_row, valid):
    """Launch the kernel once per ``MAX_PLANES`` planes of ``planes``
    (``(dest [L, R, W], staging [L, N, W])`` on one CUDA device, checked);
    returns the launches made (none on ``meta``), each recorded under
    ``name``. The routing goes as the caller holds it."""
    if dst_row.dtype not in _INDEX_DTYPES:
        raise TypeError(f"staged_scatter takes int32 or int64 rows on the "
                        f"GPU, got {dst_row.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"staged_scatter takes bool valid on the GPU, got "
                        f"{valid.dtype}")
    planes = [(d, s) for d, s in planes if d.shape[0] and d.shape[-1]]
    n = dst_row.shape[0]
    if n == 0 or not planes:
        return 0
    dev = planes[0][0].device
    meta = is_meta(planes[0][0])
    launches = 0
    for k in range(0, len(planes), MAX_PLANES):
        part = planes[k:k + MAX_PLANES]
        record(name, part[0][0], _table_cost, part, dst_row)
        if meta:
            continue
        lib = build.load_library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        m = len(part)
        es = [d.element_size() for d, _ in part]

        def arr(ctype, xs):
            return (ctype * m)(*xs)
        with build.on_device(dev):
            err = lib.staged_scatter_launch(
                m, arr(ctypes.c_void_p, [d.data_ptr() for d, _ in part]),
                arr(ctypes.c_void_p, [s.data_ptr() for _, s in part]),
                arr(ctypes.c_longlong, [d.shape[-1] * e
                                        for (d, _), e in zip(part, es)]),
                arr(ctypes.c_longlong, [d.stride(0) * e
                                        for (d, _), e in zip(part, es)]),
                arr(ctypes.c_longlong, [s.stride(0) * e
                                        for (_, s), e in zip(part, es)]),
                arr(ctypes.c_int, [d.shape[0] for d, _ in part]),
                arr(ctypes.c_int, [d.shape[1] for d, _ in part]),
                dst_row.data_ptr(), dst_row.element_size(), dst_row.stride(0),
                valid.data_ptr(), valid.stride(0), n, min(es), stream)
        if err != 0:
            raise RuntimeError(f"staged_scatter launch failed: CUDA error "
                               f"{err}")
        launches += 1
    return launches


def staged_scatter_planes(planes: Sequence[Plane], dst_row: torch.Tensor,
                          valid: torch.Tensor) -> None:
    """Drain one routing list into a table of planes, IN PLACE: for each
    ``(dest [L, R, W], staging [L, N, W])`` pair (layers may be strided
    apart; planes may differ in width, layer count, row count and dtype),
    ``dest[l][dst_row[i]] = staging[l][i]`` where ``valid[i]``. The paged
    drain passes the K and V planes of every shard on one device: one
    launch (one per ``MAX_PLANES`` planes) for all of them."""
    planes = list(planes)
    if not planes:
        return
    dev = planes[0][0].device
    for dest, staging in planes:
        _check(dest, staging, dst_row, valid, lead=1)
        if dest.device != dev:
            raise ValueError("staged_scatter_planes: every plane must be on "
                             "one device")
    if dev.type == "cpu":
        staged_scatter_planes_ref(planes, dst_row, valid)
        return
    staged_scatter_planes.launches += _launch("staged_scatter", planes,
                                              dst_row, valid)


def staged_scatter(dest, staging, dst_row, valid) -> torch.Tensor:
    """Drain staged rows into destination rows, IN PLACE on ``dest``
    (returned). ``dest[R, W]``, ``staging[N, W]``, ``dst_row int[N]``,
    ``valid bool[N]``: a table of one plane of one layer."""
    _check(dest, staging, dst_row, valid, lead=0)
    if dest.device.type == "cpu":
        return staged_scatter_ref(dest, staging, dst_row, valid, inplace=True)
    staged_scatter.launches += _launch(
        "staged_scatter", [(dest.unsqueeze(0), staging.unsqueeze(0))],
        dst_row, valid)
    return dest


def staged_scatter_layers(dest, staging, dst_row, valid) -> torch.Tensor:
    """Drain all layers of one plane in ONE launch, IN PLACE: a table of
    one. ``dest[L, R, W]`` (layers may be strided apart: a pool with spare
    rows after row ``R`` passes a narrowed view), ``staging[L, N, W]``; the
    routing ``dst_row``/``valid`` [N] is shared by every layer."""
    _check(dest, staging, dst_row, valid, lead=1)
    if dest.device.type == "cpu":
        staged_scatter_planes_ref([(dest, staging)], dst_row, valid)
        return dest
    staged_scatter_layers.launches += _launch(
        "staged_scatter", [(dest, staging)], dst_row, valid)
    return dest


def staged_gather_ref(src: torch.Tensor, dst_row: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """Plain version of the drain's adjoint: ``out[i] = src[dst_row[i]]``
    where ``valid[i]`` and the row lies in ``[0, R)``, else zeros; ``src
    [R, W]`` -> ``[N, W]``."""
    keep = valid.bool() & (dst_row >= 0) & (dst_row < src.shape[0])
    rows = torch.where(keep, dst_row, 0).long()
    return torch.where(keep[:, None], src[rows], torch.zeros((), dtype=src.dtype,
                                                             device=src.device))


def staged_gather(src: torch.Tensor, dst_row: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """The drain's adjoint, a row gather over the drain's routing list:
    ``out[i] = src[dst_row[i]]`` where ``valid[i]`` and ``0 <= dst_row[i] <
    R``, else zeros; ``src [R, W]`` row-contiguous -> a fresh ``[N, W]``. One
    launch of ``csrc/staged_scatter.cu::gather_rows_kernel`` on a CUDA
    tensor (the routing read as given, int32 or int64), the plain version on
    a CPU one."""
    n = dst_row.shape[0]
    if src.dim() != 2 or valid.shape != (n,) or dst_row.dim() != 1:
        raise ValueError(f"staged_gather: src [R, W], dst_row / valid [N]; "
                         f"got {tuple(src.shape)}, {tuple(dst_row.shape)}, "
                         f"{tuple(valid.shape)}")
    if dst_row.device != src.device or valid.device != src.device:
        raise ValueError("all staged_gather operands must share a device")
    if src.device.type == "cpu":
        return staged_gather_ref(src, dst_row, valid)
    if src.element_size() not in (2, 4):
        raise TypeError(f"staged_gather takes 2- or 4-byte elements, got "
                        f"{src.dtype}")
    if dst_row.dtype not in _INDEX_DTYPES or valid.dtype != torch.bool:
        raise TypeError(f"staged_gather takes int32 or int64 rows and bool "
                        f"valid on the GPU, got {dst_row.dtype} / "
                        f"{valid.dtype}")
    src = src.contiguous()
    out = torch.empty((n, src.shape[1]), dtype=src.dtype, device=src.device)
    if n == 0 or src.shape[1] == 0:
        return out.zero_()
    e = src.element_size()
    record("staged_gather", src, k1_gather_cost, n, n, src.shape[1], e,
           dst_row.element_size())
    if is_meta(src):
        return out
    with build.on_device(src.device):
        err = build.load_library().staged_gather_launch(
            out.data_ptr(), src.data_ptr(), src.shape[1] * e, src.shape[0],
            dst_row.data_ptr(), dst_row.element_size(), dst_row.stride(0),
            valid.data_ptr(), valid.stride(0), n, e,
            torch.cuda.current_stream(src.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"staged_gather launch failed: CUDA error {err}")
    staged_gather.launches += 1
    return out


class StagedDrainFunction(torch.autograd.Function):
    """``staged_drain`` under autograd: the forward is one K1 launch into a
    fresh zero buffer, the backward the adjoint ``staged_gather`` (the
    destination's gradient read back to the staging rows; a dropped entry
    gets zeros, as JAX's ``mode="drop"`` gives)."""

    @staticmethod
    def forward(ctx, staging, dst_row, valid, n_rows):
        ctx.save_for_backward(dst_row, valid)
        return _drain(staging, dst_row, valid, n_rows)

    @staticmethod
    def backward(ctx, grad_buf):
        dst_row, valid = ctx.saved_tensors
        return staged_gather(grad_buf, dst_row, valid), None, None, None


def _drain(staging, dst_row, valid, n_rows):
    dest = torch.zeros((n_rows, staging.shape[1]), dtype=staging.dtype,
                       device=staging.device)
    _check(dest, staging, dst_row, valid, lead=0)
    if dest.device.type == "cpu":
        return staged_scatter_ref(dest, staging, dst_row, valid, inplace=True)
    staged_drain.launches += _launch(
        "staged_drain", [(dest.unsqueeze(0), staging.unsqueeze(0))],
        dst_row, valid)
    return dest


def staged_drain(staging: torch.Tensor, dst_row: torch.Tensor,
                 valid: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The functional drain, JAX's ``zeros.at[dst].set(staging,
    mode="drop")``: a fresh zero ``[n_rows, W]`` buffer with each valid,
    in-range ``staging[i]`` at row ``dst_row[i]``. One K1 launch on a CUDA
    tensor (counted as ``staged_drain``'s), differentiable in ``staging``:
    its backward is ``staged_gather``."""
    return StagedDrainFunction.apply(staging, dst_row, valid, int(n_rows))


staged_scatter.launches = 0
staged_scatter_layers.launches = 0
staged_scatter_planes.launches = 0
staged_drain.launches = 0
staged_gather.launches = 0
