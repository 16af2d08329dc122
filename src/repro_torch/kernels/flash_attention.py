"""Port of repro/kernels/flash_attention.py (+ ``flash_attention_ref`` of
repro/kernels/ref.py): the prefill attention core.

Source note
-----------
Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py::
flash_attention`` (``_attn_kernel``): causal attention with the queries
aligned to the END of the key stream (``q_offset = T - S``), an optional
sliding window, GQA by index (kv head = q head // group). Bound: operations
(``4 * D * Hq * live (q, k) pairs`` FLOP against one read of q, K, V and one
write of the output). ``csrc/flash_attention.cu`` keeps
the Pallas kernel's online-softmax form, built for Hopper in bf16: one block
per 192 query rows of a head, three consumer warpgroups of 64 rows and a
producer warpgroup that loads Q once and 64-key K/V tiles through rings of
stages by TMA (``cp.async.bulk.tensor`` over 4-D tensor maps of the caller's
strides, 128-byte swizzled, ``mbarrier``s full/empty); Q.K^T and P.V run as
``wgmma`` (bf16 in, fp32 accumulate, P from registers). Tiles the causal
diagonal and the window rule out are never loaded; the rest are masked by
absolute position. head_dim 120 is two 64-column boxes whose columns
120-127 lie past the tensor and arrive as zeros. float32 takes a CUDA-core
path. A masked key adds exactly 0, as the plain version's -1e30 does in a
row with a live key, and every row the wrapper accepts has one. The Pallas wrapper's
block-halving for ragged S and T does not carry over: the kernel masks its
own edges.

Layout: ``[B, H, S, D]`` as the JAX function takes it, with any strides whose
last dimension is dense, so the model passes its ``[B, S, H, D]`` tensors
transposed, without a copy; the output has the query's strides. In bf16 each
operand becomes a tensor map (``tensor_map_geometry``): its pointer and
strides must be whole 16-byte units.

On a CPU tensor the wrapper runs the plain version (over blocks of 1024
query rows once S * T passes 4096 * 2048, as the JAX package's ``sdpa``
does); on a CUDA tensor it launches the kernel or raises; on a ``meta``
tensor it makes the outputs, skips the launch and adds the kernel's cost
(``cost.k3_cost``, ``cost.k3_bwd_cost``) to the active ``KernelCounter``.

Training: ``FlashAttentionFunction`` runs K3 under autograd. Its forward
asks K3 for each row's log-sum-exp too (``flash_attention_lse``: the same
launch, given a pointer it stores ``lse``; the serving launch passes none);
its backward is ``flash_attention_bwd``, the hand-written
``csrc/flash_attention_bwd.cu``. It replaces no TPU kernel: the JAX package
takes this gradient by autodiff of ``sdpa``, while the port runs K3 there.
Bound: the larger of ``10 * D * Hq * live pairs`` FLOP at the tensor cores'
rate and one read of q, k, v, out, dout and lse and one write of dq, dk and
dv (bytes at the training shapes, S = 512 and D = 64). FlashAttention-2's
form recomputes both score products in each pass (14 D FLOP a pair), more
than the bound allows on CUDA cores, so in bf16 every product is ``wgmma``
on TMA-fed tiles, on K3's forward's machinery: a prep launch (delta =
rowsum(dout * out) and the lse in base 2, 16-byte loads), a dK / dV pass
(a block per 64 keys and KV head; the Q and dO tiles of every head of the
group streamed through a ring; S^T, dP^T from shared memory, P^T and dS^T
rounded to bf16 in registers as the A operands of dV and dK; GQA summed in
the block) and a dQ pass (a block per 64 query rows; K and V streamed),
two blocks an SM. No atomics: the result repeats bit for bit. Each bf16
operand must be one a tensor map takes (``tensor_map_geometry``). float32
runs the same passes on CUDA cores, the design the fp32 parity runs are
held on. Its plain version is autograd through the plain forward, on CPU
tensors only.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .cost import is_meta, k3_bwd_cost, k3_cost, record

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


def _mask(s, t, q0, causal, window, device):
    """bool ``[S, T]``: the keys each query row at absolute position ``q0 +
    i`` may see."""
    qpos = torch.arange(s, device=device)[:, None] + q0
    kpos = torch.arange(t, device=device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos       # queries may sit at the end of kv
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def _ref_rows(q, k, v, causal, window, q0):
    """The plain version for query rows at absolute positions ``q0 ..``
    against heads already matched (``Hq`` K/V heads)."""
    s, t, d = q.shape[2], k.shape[2], q.shape[3]
    logits = torch.einsum("bhsd,bhtd->bhst", q, k).float() * (d ** -0.5)
    mask = _mask(s, t, q0, causal, window, q.device)
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


# the bf16 kernel's TMA boxes are 64 columns (128 swizzled bytes) wide
BOX_COLS = 64


def tensor_map_geometry(x: torch.Tensor) -> dict:
    """The 4-D TMA tensor map of a bf16 ``[B, H, N, D]`` operand of the
    kernel (``csrc/flash_attention.cu::make_map``): ``dims`` innermost first
    ``(D, N, H, B)``, ``byte_strides`` of ``(N, H, B)`` as the map takes
    them, the element ``strides`` ``(batch, head, row)`` as the launch takes
    them, and ``boxes``, the 64-column boxes that cover D (columns past D read as
    zeros). A dimension of extent 1 is never stepped, so its stride becomes
    one 16-byte unit. Raises ``ValueError`` where the map cannot be made:
    a pointer or a stride that is not a whole number of 16-byte units, a
    last dimension that is not dense, or D past 128."""
    if x.dim() != 4 or x.element_size() != 2:
        raise ValueError("a tensor map is made of a 16-bit [B, H, N, D] tensor")
    b, h, n, d = x.shape
    vec = 16 // x.element_size()
    if d > 2 * BOX_COLS or d % vec or x.stride(3) != 1:
        raise ValueError(f"head_dim {d} with stride {x.stride(3)}: a tensor "
                         f"map takes a dense row of <= 128 columns, a "
                         f"multiple of {vec}")
    strides = tuple(vec if ext == 1 else st
                    for ext, st in zip((b, h, n), x.stride()[:3]))
    if x.data_ptr() % 16 or any(st <= 0 or st % vec for st in strides):
        raise ValueError(f"bfloat16 flash_attention needs 16-byte aligned "
                         f"rows (pointer {x.data_ptr()}, strides "
                         f"{x.stride()})")
    return dict(dims=(d, n, h, b), strides=strides,
                byte_strides=tuple(st * x.element_size()
                                   for st in strides[::-1]),
                boxes=-(-d // BOX_COLS))


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


def _forward(q, k, v, causal, window, lse):
    """One K3 launch on CUDA operands (checked by ``_check``); ``lse``, an
    fp32 ``[B, Hq, S]`` tensor or None, receives each row's log-sum-exp."""
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
    if q.dtype == torch.bfloat16:
        strides = [tensor_map_geometry(x)["strides"] for x in ts]
    else:
        strides = [x.stride()[:3] for x in ts]
    record("flash_attention", q, k3_cost, q.shape, k.shape,
           q.element_size(), causal, window, lse is not None)
    if is_meta(q):
        return out
    with build.on_device(q.device):
        err = build.load_library().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, hq, hkv, s, t, d, *strides[0], *strides[1], *strides[2],
            *strides[3], None if lse is None else lse.data_ptr(),
            int(causal), int(window), float(d ** -0.5), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err >= build.MAP_ERROR:
        raise RuntimeError(f"flash_attention: cuTensorMapEncodeTiled refused a "
                           f"tensor map (CUresult {err - build.MAP_ERROR})")
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


def flash_attention(q, k, v, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """Tiled causal (optionally sliding-window) attention; q ``[B,Hq,S,D]``,
    k/v ``[B,Hkv,T,D]`` -> ``[B,Hq,S,D]`` in ``q.dtype``."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return _ref_blocked(q, k, v, causal, window)
    return _forward(q, k, v, causal, window, None)


def flash_attention_lse_ref(q, k, v, causal: bool = True,
                            window: int = 0) -> torch.Tensor:
    """Plain version of K3's ``lse``: the fp32 log-sum-exp of each row's
    scaled, masked scores ``[B, Hq, S]``."""
    k, _ = _repeat_kv(k, k, q.shape[1])
    s, t, d = q.shape[2], k.shape[2], q.shape[3]
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * d ** -0.5
    mask = _mask(s, t, t - s, causal, window, q.device)
    return torch.logsumexp(logits.masked_fill(~mask, float("-inf")), dim=-1)


def flash_attention_lse(q, k, v, causal: bool = True, window: int = 0):
    """K3 that also returns each row's log-sum-exp (fp32 ``[B, Hq, S]``),
    what the backward needs: ``(out, lse)``. One K3 launch on a CUDA tensor
    (counted as ``flash_attention``'s), the plain versions on a CPU one."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return (_ref_blocked(q, k, v, causal, window),
                flash_attention_lse_ref(q, k, v, causal, window))
    b, hq, s, _ = q.shape
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    return _forward(q, k, v, causal, window, lse), lse


def flash_attention_bwd_ref(q, k, v, dout, causal: bool = True,
                            window: int = 0):
    """Plain version of the backward: autograd through the plain forward
    (``_ref_blocked``) on the same operands -> ``(dq, dk, dv)``."""
    with torch.enable_grad():
        qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
        out = _ref_blocked(qq, kk, vv, causal, window)
        return torch.autograd.grad(out, (qq, kk, vv), dout)


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = True,
                        window: int = 0):
    """The gradients ``(dq, dk, dv)`` of one ``flash_attention`` call, from
    its operands, its output and its ``lse`` (``flash_attention_lse``), in
    the operands' dtype and strides. On a CUDA tensor one call of
    ``csrc/flash_attention_bwd.cu`` (three launches: delta, dK / dV, dQ,
    counted as one; in bf16 every operand must be one a tensor map takes);
    on a CPU tensor the plain version, which ignores ``out`` and ``lse``."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, dout, causal, window)
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention_bwd takes float32 or bfloat16, got "
                        f"{q.dtype}")
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if causal and s > t:
        raise ValueError(f"causal attention needs S <= T, got S={s}, T={t}")
    vec = 16 // q.element_size()
    if d > 128 or (q.dtype == torch.bfloat16 and d % vec):
        raise ValueError(f"head_dim {d} in {q.dtype}: the kernel takes "
                         f"<= 128, a multiple of {vec} in bfloat16")
    if out.shape != q.shape or dout.shape != q.shape \
            or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError("out and dout must be like q")
    if lse.shape != (b, hq, s) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 [{b}, {hq}, {s}]")
    if dout.stride(3) != 1:
        dout = dout.contiguous()
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ts = (q, k, v, out, dout, dq, dk, dv)
    if any(x.stride(3) != 1 for x in ts):
        raise ValueError("flash_attention_bwd needs a dense last dimension")
    if q.dtype == torch.bfloat16:
        strides = [tensor_map_geometry(x)["strides"] for x in ts]
    else:
        strides = [x.stride()[:3] for x in ts]
    # delta and the lse in base 2, [B * Hq] rows of S rounded up to 64
    scratch = torch.empty((2 * b * hq * -(-s // 64) * 64,),
                          dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*[st for x in strides for st in x])
    record("flash_attention_bwd", q, k3_bwd_cost, q.shape, k.shape,
           q.element_size(), causal, window)
    if is_meta(q):
        return dq, dk, dv
    with build.on_device(q.device):
        err = build.load_library().flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, hq, hkv, s, t, d,
            strides, int(causal), int(window), float(d ** -0.5),
            _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err >= build.MAP_ERROR:
        raise RuntimeError(f"flash_attention_bwd: cuTensorMapEncodeTiled "
                           f"refused a tensor map (CUresult "
                           f"{err - build.MAP_ERROR})")
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error "
                           f"{err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """K3 under autograd: the forward is ``flash_attention_lse`` (one K3
    launch, saving q, k, v, out and lse), the backward
    ``flash_attention_bwd`` (the hand-written backward on the card; on the
    CPU autograd through the plain version). ``apply(q, k, v, causal,
    window)`` in ``flash_attention``'s layout."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        if q.device.type == "cpu":
            # the plain backward recomputes the plain forward: no lse needed
            out, lse = _ref_blocked(q, k, v, causal, window), None
        else:
            out, lse = flash_attention_lse(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, ctx.causal,
                                         ctx.window)
        return dq, dk, dv, None, None


flash_attention.launches = 0
flash_attention_bwd.launches = 0
