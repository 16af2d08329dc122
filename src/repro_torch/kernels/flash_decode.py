"""Port of repro/kernels/flash_decode.py, paged part (+
``flash_decode_paged_ref`` of repro/kernels/ref.py): the fused paged read.

Source note
-----------
Replaces the Pallas TPU kernel ``repro/kernels/flash_decode.py::
flash_decode_paged`` (``_paged_kernel``): softmax(q.K^T * D^-1/2, masked to
-1e30) over (pool rows reached through the page table) U (staging-ring
lanes), fp32 softmax, probabilities cast to ``q.dtype``, times V. The TPU
kernel parks every score and value of a slot in VMEM and runs one
full-width softmax at the last page; that scratch does not fit a Hopper
block's shared memory for long views. ``csrc/flash_decode_paged.cu`` keeps
the plain version's arithmetic with two passes over K instead: pass 1 the
running max and sum of each query row, pass 2 ``p = exp(s - m) / l`` rounded
to the I/O type, times V, with an fp32 accumulator. (The online-rescale form
never rounds the probabilities and would differ from the plain version by
about one bf16 ulp of the output; two passes do not.) One block per (slot,
KV head) serves the whole GQA group and all C columns, so each K/V row
leaves device memory once per pass; the block reads its own row of the page
table; the ring lanes are one more KV source after the last page. Masked
entries are scored -1e30, not skipped, so an all-masked row is the same
finite uniform mean the plain version gives. Bound: bytes, those of the K
and V rows that some query column of their slot sees (a masked key adds
exactly 0 wherever a live one exists), ``n_live * Hkv * D * 2 * elemsize``.
The kernel as written reads all ``B * (P*ps + R)`` rows, K twice: ``wgmma``,
TMA, split-KV and skipping dead pages are later work.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    Returns ``[B, C, Hq, D]`` in ``q.dtype``."""
    _check(q, pages_k, pages_v, blocks, view_ok, ring_k, ring_v, ring_ok)
    if q.device.type == "cpu":
        return flash_decode_paged_ref(q, pages_k, pages_v, blocks, view_ok,
                                      ring_k, ring_v, ring_ok)
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_decode_paged takes float32 or bfloat16, got "
                        f"{q.dtype}")
    b, c, hq, d = q.shape
    ps, hkv = pages_k.shape[1], pages_k.shape[2]
    p = blocks.shape[1]
    r = 0 if ring_k is None else ring_k.shape[1]
    lanes = d // (16 // q.element_size())  # lanes sharing one K/V row
    if d % (16 // q.element_size()) or not 1 <= lanes <= 32 \
            or lanes & (lanes - 1):
        raise ValueError(
            f"head_dim {d} in {q.dtype}: the row must split into a power of "
            f"two (<= 32) of 16-byte pieces")
    if p * ps + r == 0:
        raise ValueError("empty KV set")
    ts = [q, pages_k, pages_v] + ([ring_k, ring_v] if r else [])
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash_decode_paged needs contiguous q, pages, ring")
    if any(t.data_ptr() % 16 for t in ts[1:]):
        raise ValueError("pages and ring planes must be 16-byte aligned")
    blocks32 = blocks.to(torch.int32).contiguous()
    vok = view_ok.to(torch.bool).contiguous()
    rok = ring_ok.to(torch.bool).contiguous() if r else None
    out = torch.empty_like(q)
    with build.on_device(q.device):
        err = build.load_library().flash_decode_paged_launch(
            q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(),
            blocks32.data_ptr(), vok.data_ptr(),
            ring_k.data_ptr() if r else None,
            ring_v.data_ptr() if r else None,
            rok.data_ptr() if r else None,
            out.data_ptr(), b, c, hq, hkv, d, p, ps, r,
            float(d ** -0.5), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_decode_paged launch failed: CUDA error {err}")
    flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0
