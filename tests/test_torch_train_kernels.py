"""The training kernels' plain versions against the JAX package on the CPU.

* K3's backward: ``flash_attention_bwd`` (on a CPU tensor autograd through
  the plain forward) and ``FlashAttentionFunction`` under autograd, against
  ``jax.vjp`` of JAX's ``ref.flash_attention_ref`` on the same numpy inputs
  and cotangent: causal, sliding window, GQA, S < T (queries at the end of
  the keys), non-causal; fp32 within atol 1e-5, rtol 1e-5 (two CPU fp32
  sums in another order). ``flash_attention_lse`` (the forward's per-row
  log-sum-exp the card's backward reads) against a numpy log-sum-exp of the
  masked scores, within 1e-5.
* The drain's adjoint: ``staged_gather`` against ``jax.vjp`` of
  ``.at[dst].set(staged, mode="drop")`` (dropped, sentinel and out-of-range
  rows included), exactly; and the staged and direct dispatch under grad
  (``dispatch_staged`` draining through ``staged_drain``,
  ``dispatch_direct`` a plain scatter) against ``jax.vjp`` of JAX's,
  buffer and input gradient exactly (a copy and its adjoint gather move
  values unchanged).
* On CPU tensors the new wrappers run their plain versions: no launch is
  counted.
* The bf16 backward on the card makes a TMA tensor map of each of its eight
  operands: each, in the layout the attention layer gives it under
  autograd, is one ``tensor_map_geometry`` takes, at head_dim 64, 80, 120
  and 128.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.models import moe as JM
from repro_torch import kernels as K
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM

torch.set_num_threads(1)

FA = importlib.import_module("repro_torch.kernels.flash_attention")

TOL = dict(atol=1e-5, rtol=1e-5)

# b, hq, hkv, s, t, d, causal, window
ATTN_CASES = [
    (1, 2, 2, 16, 16, 8, True, 0),      # causal
    (1, 2, 2, 20, 20, 8, True, 6),      # sliding window
    (2, 4, 1, 12, 12, 8, True, 0),      # GQA group 4
    (1, 4, 2, 5, 13, 8, True, 0),       # S < T, the queries at the end
    (1, 2, 1, 7, 11, 8, False, 0),      # non-causal, S < T
    (1, 4, 2, 9, 17, 16, True, 5),      # window, GQA, S < T
]


def _attn_inputs(case, seed=0):
    b, hq, hkv, s, t, d, _, _ = case
    rs = np.random.RandomState(seed)
    q = rs.randn(b, hq, s, d).astype(np.float32)
    k = rs.randn(b, hkv, t, d).astype(np.float32)
    v = rs.randn(b, hkv, t, d).astype(np.float32)
    do = rs.randn(b, hq, s, d).astype(np.float32)
    return q, k, v, do


def _jax_grads(q, k, v, do, causal, window):
    out, vjp = jax.vjp(lambda a, b_, c: JR.flash_attention_ref(
        a, b_, c, causal=causal, window=window), *map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_flash_attention_bwd_matches_jax_grad(case):
    causal, window = case[6], case[7]
    q, k, v, do = _attn_inputs(case)
    want_out, want = _jax_grads(q, k, v, do, causal, window)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = K.flash_attention_lse(tq, tk, tv, causal, window)
    np.testing.assert_allclose(out.numpy(), want_out, **TOL)
    got = K.flash_attention_bwd(tq, tk, tv, out, lse, tdo, causal, window)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_flash_attention_function_under_autograd(case):
    """The Function in the model's layout (``[B, S, H, D]`` tensors seen
    transposed): gradients reach q, k and v as JAX's do."""
    causal, window = case[6], case[7]
    q, k, v, do = _attn_inputs(case, seed=1)
    _, want = _jax_grads(q, k, v, do, causal, window)
    leaves = [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))
              .requires_grad_() for a in (q, k, v)]
    out = K.FlashAttentionFunction.apply(
        *(x.transpose(1, 2) for x in leaves), causal, window)
    out.backward(torch.from_numpy(do))
    for name, x, w in zip("qkv", leaves, want):
        np.testing.assert_allclose(x.grad.transpose(1, 2).numpy(), w, **TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_flash_attention_lse_is_the_masked_logsumexp(case):
    b, hq, hkv, s, t, d, causal, window = case
    q, k, _, _ = _attn_inputs(case, seed=2)
    kk = np.repeat(k, hq // hkv, axis=1)
    logits = np.einsum("bhsd,bhtd->bhst", q.astype(np.float64), kk) * d ** -0.5
    qpos = np.arange(s)[:, None] + (t - s)
    kpos = np.arange(t)[None, :]
    mask = np.ones((s, t), bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    logits = np.where(mask, logits, -np.inf)
    mx = logits.max(-1, keepdims=True)
    want = (mx + np.log(np.exp(logits - mx).sum(-1, keepdims=True)))[..., 0]
    got = K.flash_attention_lse_ref(*map(torch.from_numpy, (q, k, k)),
                                    causal, window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_staged_gather_is_the_drain_adjoint(idx_dtype):
    """``staged_gather`` = the vjp of ``zeros.at[dst].set(staged,
    mode="drop")``: a valid in-range row reads its destination's gradient,
    an invalid, sentinel or out-of-range one gets zeros."""
    rs = np.random.RandomState(3)
    r, n, w = 12, 9, 5
    dst = rs.permutation(r)[:n].astype(np.int64)
    dst[2], dst[5] = r, r + 3            # the sentinel and past it
    valid = rs.rand(n) > 0.3
    valid[0] = True
    staged = rs.randn(n, w).astype(np.float32)
    ct = rs.randn(r, w).astype(np.float32)
    jdst = jnp.where(jnp.asarray(valid), jnp.asarray(dst), r)

    def drain(x):
        return jnp.zeros((r, w), jnp.float32).at[jdst].set(x, mode="drop")
    _, vjp = jax.vjp(drain, jnp.asarray(staged))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    got = K.staged_gather(torch.from_numpy(ct),
                          torch.from_numpy(dst).to(idx_dtype),
                          torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    # and the drain itself: the functional form of the same .at[].set
    buf = K.staged_drain(torch.from_numpy(staged),
                         torch.from_numpy(dst).to(idx_dtype),
                         torch.from_numpy(valid), r)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(drain(staged)))


@pytest.mark.parametrize("path", ["staged", "direct"])
@pytest.mark.parametrize("keep_frac", [1.0, 0.6])
def test_dispatch_gradient_matches_jax_vjp(path, keep_frac):
    """Under grad the staged dispatch drains through ``staged_drain``, the
    direct one stays a plain ``index_copy_``; the buffer and the gradient
    that reaches ``x`` equal JAX's dispatch and its vjp, with capacity
    drops (capacity 4 for 16 x 2 assignments over 4 experts) and
    assignments not kept."""
    rs = np.random.RandomState(4)
    t, k, d, e, cap = 16, 2, 6, 4, 4
    x = rs.randn(t, d).astype(np.float32)
    idx = np.stack([rs.choice(e, k, replace=False) for _ in range(t)]
                   ).astype(np.int32)
    keep = rs.rand(t, k) < keep_frac
    ct = rs.randn(e, cap, d).astype(np.float32)
    jfn = JM.dispatch_staged if path == "staged" else JM.dispatch_direct
    tfn = TM.dispatch_staged if path == "staged" else TM.dispatch_direct
    jout, vjp = jax.vjp(lambda a: jfn(a, jnp.asarray(idx), jnp.asarray(keep),
                                      cap, e), jnp.asarray(x))
    zeros = tuple(jnp.zeros_like(o) for o in jout[1:])
    jgx = np.asarray(vjp((jnp.asarray(ct),) + zeros)[0])
    tx = torch.from_numpy(x).requires_grad_()
    K.reset_launch_counts()
    tout = tfn(tx, torch.from_numpy(idx).long(), torch.from_numpy(keep), cap,
               e)
    (gx,) = torch.autograd.grad(tout[0], tx, torch.from_numpy(ct))
    np.testing.assert_array_equal(tout[0].detach().numpy(), np.asarray(jout[0]))
    np.testing.assert_array_equal(tout[-1].numpy(), np.asarray(jout[-1]))
    np.testing.assert_array_equal(gx.numpy(), jgx)
    # the plain versions ran: nothing counted as a launch
    counts = K.launch_counts()
    assert counts["staged_drain"] == counts["staged_gather"] == 0


def test_training_wrappers_count_no_launch_on_the_cpu():
    K.reset_launch_counts()
    case = ATTN_CASES[0]
    q, k, v, do = map(torch.from_numpy, _attn_inputs(case))
    out, lse = K.flash_attention_lse(q, k, v)
    K.flash_attention_bwd(q, k, v, out, lse, do)
    K.staged_gather(torch.ones(4, 3), torch.tensor([1, 0]),
                    torch.tensor([True, False]))
    K.staged_drain(torch.ones(2, 3), torch.tensor([1, 3]),
                   torch.tensor([True, True]), 4)
    counts = K.launch_counts()
    assert {k_: counts[k_] for k_ in ("flash_attention", "flash_attention_bwd",
                                      "staged_drain", "staged_gather")} == \
        dict(flash_attention=0, flash_attention_bwd=0, staged_drain=0,
             staged_gather=0)


@pytest.mark.parametrize("d", [64, 80, 120, 128])
def test_backward_operands_take_tensor_maps(d, monkeypatch):
    """Through ``layers.attention`` under autograd in bf16 (a causal self
    read, GQA group 2): q, k and v as the layer hands them to the backward
    (transposed ``[B, S, H, D]`` views), ``dout`` as autograd delivers it
    through the output projection, and ``out``, dq, dk and dv as the card's
    wrappers make them (``empty_like``) are each a layout a TMA tensor map
    takes. A layout refused here would be a refused map on the card."""
    cfg = ModelConfig(name="maps", family="dense", n_layers=1, d_model=32,
                      vocab=8, n_heads=4, n_kv_heads=2, head_dim=d)
    gen = torch.Generator().manual_seed(d)

    def w(*shape):
        return torch.randn(shape, generator=gen).to(torch.bfloat16)
    p = dict(wq=w(32, 4, d), wk=w(32, 2, d), wv=w(32, 2, d), wo=w(4, d, 32))
    x = w(2, 12, 32).requires_grad_()
    seen = {}
    real = FA.flash_attention_bwd

    def spy(q, k, v, out, lse, dout, causal=True, window=0):
        seen.update(q=q, k=k, v=v, dout=dout)
        return real(q, k, v, out, lse, dout, causal, window)
    monkeypatch.setattr(FA, "flash_attention_bwd", spy)
    y = TL.attention(cfg, p, x, torch.arange(12).expand(2, 12))
    y.float().square().sum().backward()
    ops = dict(seen, out=torch.empty_like(seen["q"]),
               dq=torch.empty_like(seen["q"]), dk=torch.empty_like(seen["k"]),
               dv=torch.empty_like(seen["v"]))
    for name, t in ops.items():
        assert t.dtype == torch.bfloat16 and t.shape[-1] == d, name
        geo = FA.tensor_map_geometry(t)   # raises where no map can be made
        assert geo["boxes"] == (1 if d <= 64 else 2), name

