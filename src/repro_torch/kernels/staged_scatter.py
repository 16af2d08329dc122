"""Port of repro/kernels/staged_scatter.py (+ ``staged_scatter_ref`` of
repro/kernels/ref.py): the unload path's drain.

Source note
-----------
Replaces the Pallas TPU kernel ``repro/kernels/staged_scatter.py::
staged_scatter`` (``_drain_kernel``). It computes
``dest[dst_row[i]] = staging[i]`` where ``valid[i]``, in place; valid rows
are unique within one drain. The TPU version has an unpredicated body and a
wrapper that sorts valid entries first and duplicates the last valid write
into the tail; on Hopper a per-row predicate read by the block is free, so
``csrc/staged_scatter.cu`` runs one block per staged row, skips rows that
are not live or out of range, and copies the row as 16-byte vectors (by
element size when something is misaligned). Bound: bytes. It moves
``2 * n_valid * W * elemsize`` bytes per plane; nothing else is read but
``5 * N`` bytes of routing. The batched entry drains every layer of one
plane in one launch (grid ``(N, L)``), because a per-layer drain of the KV
pool would launch ``2 * L`` kernels.

On a CPU tensor the wrappers run the plain version; on a CUDA tensor they
launch the kernel or raise.
"""
from __future__ import annotations

import torch

from . import build


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


def _launch(dest, staging, dst_row, valid, n_layers, dest_stride, stage_stride):
    n, w = staging.shape[-2], staging.shape[-1]
    rows = dst_row.to(torch.int32).contiguous()
    ok = valid.to(torch.bool).contiguous()
    es = dest.element_size()
    with build.on_device(dest.device):
        err = _c_launch(
            dest, staging, rows, ok, n_layers, n, w, es, dest_stride,
            stage_stride)
    if err != 0:
        raise RuntimeError(f"staged_scatter launch failed: CUDA error {err}")


def _c_launch(dest, staging, rows, ok, n_layers, n, w, es, dest_stride,
              stage_stride) -> int:
    return build.load_library().staged_scatter_launch(
        dest.data_ptr(), staging.data_ptr(), rows.data_ptr(), ok.data_ptr(),
        n_layers, n, dest.shape[-2], w * es, es,
        dest_stride * es, stage_stride * es,
        torch.cuda.current_stream(dest.device).cuda_stream)


def staged_scatter(dest, staging, dst_row, valid) -> torch.Tensor:
    """Drain staged rows into destination rows, IN PLACE on ``dest``
    (returned). ``dest[R, W]``, ``staging[N, W]``, ``dst_row int[N]``,
    ``valid bool[N]``."""
    _check(dest, staging, dst_row, valid, lead=0)
    if dest.device.type == "cpu":
        return staged_scatter_ref(dest, staging, dst_row, valid, inplace=True)
    if staging.shape[0] == 0:
        return dest
    _launch(dest, staging, dst_row, valid, 1, 0, 0)
    staged_scatter.launches += 1
    return dest


def staged_scatter_layers(dest, staging, dst_row, valid) -> torch.Tensor:
    """Batched entry: drain all layers of one plane in ONE launch, IN PLACE.
    ``dest[L, R, W]`` (layers may be strided apart: a pool with spare rows
    after row ``R`` passes a narrowed view), ``staging[L, N, W]``; the
    routing ``dst_row``/``valid`` [N] is shared by every layer."""
    _check(dest, staging, dst_row, valid, lead=1)
    if dest.device.type == "cpu":
        for l in range(dest.shape[0]):
            staged_scatter_ref(dest[l], staging[l], dst_row, valid,
                               inplace=True)
        return dest
    if staging.shape[1] == 0 or dest.shape[0] == 0:
        return dest
    _launch(dest, staging, dst_row, valid, dest.shape[0],
            dest.stride(0), staging.stride(0))
    staged_scatter_layers.launches += 1
    return dest


staged_scatter.launches = 0
staged_scatter_layers.launches = 0
