"""Port of repro/kernels/flash_attention.py (+ ``flash_attention_ref`` of
repro/kernels/ref.py): the prefill attention core.

Source note
-----------
Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py::
flash_attention`` (``_attn_kernel``): causal attention with the queries
aligned to the END of the key stream (``q_offset = T - S``), an optional
sliding window, GQA by index (kv head = q head // group). Bound: operations
(``4 * D * Hq * live (q, k) pairs`` FLOP against one read of q, K, V and one
write of the output). ``csrc/flash_attention.cu`` keeps the Pallas kernel's
online-softmax form but on the tensor cores: one block per 64 query rows of a
head loops over 64-key tiles, skips the tiles the causal diagonal and the
window rule out, masks the rest by absolute position, and runs Q.K^T and
P.V as ``mma.sync`` (bf16 in, fp32 accumulate) with the next K/V tile's
``cp.async`` in flight. head_dim 120 is padded to 128 with zeros in shared
memory. float32 takes a CUDA-core path. Masked scores are -1e30 as in the
plain version; every row the wrapper accepts has a live key, so no row is
all-masked. The Pallas wrapper's block-halving for ragged S and T does not
carry over: the kernel masks its own edges.

Layout: ``[B, H, S, D]`` as the JAX function takes it, with any strides whose
last dimension is dense, so the model passes its ``[B, S, H, D]`` tensors
transposed, without a copy; the output has the query's strides.

On a CPU tensor the wrapper runs the plain version (over blocks of 1024
query rows once S * T passes 4096 * 2048, as the JAX package's ``sdpa``
does); on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """Plain PyTorch version, op for op ``ref.flash_attention_ref``: q
    ``[B,Hq,S,D]``, k/v ``[B,Hkv,T,D]``; fp32 logits, -1e30 mask, fp32
    softmax cast to ``q.dtype``, then P.V."""
    k, v = _repeat_kv(k, v, q.shape[1])
    return _ref_rows(q, k, v, causal, window, k.shape[2] - q.shape[2])


def _repeat_kv(k, v, hq):
    """K/V heads repeated to the query's ``hq`` (GQA)."""
    g = hq // k.shape[1]
    if g == 1:
        return k, v
    return k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)


def _ref_rows(q, k, v, causal, window, q0):
    """The plain version for query rows at absolute positions ``q0 ..``
    against heads already matched (``Hq`` K/V heads)."""
    s, t, d = q.shape[2], k.shape[2], q.shape[3]
    logits = torch.einsum("bhsd,bhtd->bhst", q, k).float() * (d ** -0.5)
    qpos = torch.arange(s, device=q.device)[:, None] + q0
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos       # queries may sit at the end of kv
    if window > 0:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bhtd->bhsd", probs, v)


# once S * T passes this, the CPU path runs the plain version over blocks of
# query rows (each row's softmax is exact on its own), so the fp32 scores
# never materialise at [S, T]
_BLOCK_THRESHOLD = 4096 * 2048
_QBLOCK = 1024


def _ref_blocked(q, k, v, causal, window):
    s, t = q.shape[2], k.shape[2]
    if s * t <= _BLOCK_THRESHOLD or s <= _QBLOCK:
        return flash_attention_ref(q, k, v, causal, window)
    k, v = _repeat_kv(k, v, q.shape[1])
    return torch.cat([_ref_rows(q[:, :, i: i + _QBLOCK], k, v, causal, window,
                                i + t - s)
                      for i in range(0, s, _QBLOCK)], dim=2)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q must be [B,Hq,S,D] and k/v [B,Hkv,T,D]")
    b, hq, s, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or v.shape != k.shape \
            or hq % k.shape[1]:
        raise ValueError(f"bad head geometry: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if k.device != q.device or v.device != q.device:
        raise ValueError("all flash_attention operands must share a device")


def flash_attention(q, k, v, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """Tiled causal (optionally sliding-window) attention; q ``[B,Hq,S,D]``,
    k/v ``[B,Hkv,T,D]`` -> ``[B,Hq,S,D]`` in ``q.dtype``."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return _ref_blocked(q, k, v, causal, window)
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if s == 0 or t == 0:
        raise ValueError("empty query or key set")
    if causal and s > t:
        raise ValueError(f"causal attention needs S <= T, got S={s}, T={t}")
    vec = 16 // q.element_size()
    if d > 128 or (q.dtype == torch.bfloat16 and d % vec):
        raise ValueError(f"head_dim {d} in {q.dtype}: the kernel takes "
                         f"<= 128, a multiple of {vec} in bfloat16")
    out = torch.empty_like(q)      # the query's strides (dense)
    ts = (q, k, v, out)
    if any(x.stride(3) != 1 for x in ts):
        raise ValueError("flash_attention needs a dense last dimension")
    if q.dtype == torch.bfloat16 and any(
            x.data_ptr() % 16 or any(st % vec for st in x.stride()[:3])
            for x in ts):
        raise ValueError("bfloat16 flash_attention needs 16-byte aligned "
                         "rows (pointers and strides)")
    with build.on_device(q.device):
        err = build.load_library().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, hq, hkv, s, t, d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], int(causal), int(window),
            float(d ** -0.5), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
