"""The port's attention kernels on the CPU: ``flash_attention`` (prefill) and
``flash_decode`` (dense decode) run their plain PyTorch versions there, held
against the JAX package's oracles (``kernels/ref.py``) and against the Pallas
kernels in interpret mode, on the same numpy inputs. fp32: atol 2e-6, rtol
1e-4 (sums in another order). bf16: one bf16 ulp of room (atol 8e-3, rtol
1.6e-2), as for ``flash_decode_paged``. The Pallas attention kernel needs
``S % block_q == 0``: ragged shapes are held against the oracle only. The
CUDA kernels are held against the same plain versions on the GPU by
``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_attention
from repro.kernels.flash_decode import flash_decode as pallas_decode
from repro_torch import kernels as K
from repro_torch.models import layers as TL

torch.set_num_threads(1)

TOL = dict(atol=2e-6, rtol=1e-4)
TOL_BF16 = dict(atol=8e-3, rtol=1.6e-2)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

def _attn_inputs(seed, b, hq, hkv, s, t, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, hq, s, d).astype(np.float32),
            rng.randn(b, hkv, t, d).astype(np.float32),
            rng.randn(b, hkv, t, d).astype(np.float32))


# b, hq, hkv, s, t, d: GQA groups 1/2/4, S = T and S < T
ATTN_SHAPES = [(2, 4, 4, 64, 64, 16), (1, 4, 2, 64, 128, 32),
               (1, 8, 2, 128, 128, 16), (2, 4, 1, 64, 192, 24)]
ATTN_MASKS = [(True, 0), (True, 48), (False, 0), (False, 40)]
ATTN_CASES = [(shp, c, w) for shp in ATTN_SHAPES for (c, w) in ATTN_MASKS]


def _attn_id(case):
    shp, causal, window = case
    return "-".join(map(str, shp)) + ("-causal" if causal else "-full") \
        + f"-w{window}"


@pytest.mark.parametrize("case", ATTN_CASES, ids=_attn_id)
def test_flash_attention_matches_pallas_interpret(case):
    shp, causal, window = case
    q, k, v = _attn_inputs(sum(shp), *shp)
    want = np.asarray(pallas_attention(*_j(q, k, v), causal=causal,
                                       window=window, block_q=32, block_k=32,
                                       interpret=True))
    got = K.flash_attention(*_t(q, k, v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ragged S and T, a window shorter than S, one query against many keys
RAGGED_SHAPES = [(1, 4, 4, 1, 1, 8), (2, 4, 1, 37, 37, 24),
                 (1, 8, 2, 37, 100, 16), (1, 2, 2, 1, 77, 40),
                 (2, 6, 3, 50, 61, 8)]
RAGGED_CASES = [(shp, c, w) for shp in RAGGED_SHAPES
                for (c, w) in ((True, 0), (True, 7), (False, 0), (False, 9))]


@pytest.mark.parametrize("case", RAGGED_CASES, ids=_attn_id)
def test_flash_attention_matches_jax_oracle(case):
    shp, causal, window = case
    q, k, v = _attn_inputs(sum(shp) + 1, *shp)
    want = np.asarray(jref.flash_attention_ref(*_j(q, k, v), causal=causal,
                                               window=window))
    got = K.flash_attention(*_t(q, k, v), causal=causal, window=window)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 20), (False, 0)])
def test_flash_attention_bf16(causal, window):
    q, k, v = _attn_inputs(4, 1, 4, 2, 48, 64, 16)
    got = K.flash_attention(*[x.to(torch.bfloat16) for x in _t(q, k, v)],
                            causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    want = jref.flash_attention_ref(
        *[x.astype(jnp.bfloat16) for x in _j(q, k, v)], causal=causal,
        window=window)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **TOL_BF16)


@pytest.mark.parametrize("case", RAGGED_CASES[4:], ids=_attn_id)
def test_flash_attention_cpu_query_blocks(case, monkeypatch):
    """On a CPU tensor a long prompt runs the plain version over blocks of
    query rows: with blocks of 16 rows the result is the JAX oracle's."""
    import importlib
    FA = importlib.import_module("repro_torch.kernels.flash_attention")
    monkeypatch.setattr(FA, "_BLOCK_THRESHOLD", 0)
    monkeypatch.setattr(FA, "_QBLOCK", 16)
    shp, causal, window = case
    q, k, v = _attn_inputs(sum(shp) + 3, *shp)
    want = np.asarray(jref.flash_attention_ref(*_j(q, k, v), causal=causal,
                                               window=window))
    got = K.flash_attention(*_t(q, k, v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_flash_attention_cpu_blocks_a_4608_token_prompt():
    """At the sliding-window model's longest prompt (4608 tokens, window
    4096) the CPU path blocks its queries, as the JAX package's ``sdpa``
    does, and gives ``sdpa``'s result."""
    from repro.models import layers as JL
    q, k, v = _attn_inputs(17, 1, 2, 1, 4608, 4608, 8)
    want = JL.sdpa(*[jnp.asarray(x.transpose(0, 2, 1, 3))
                     for x in (q, np.repeat(k, 2, 1), np.repeat(v, 2, 1))],
                   JL.causal_mask(4608, 4608, 4096))
    got = K.flash_attention(*_t(q, k, v), causal=True, window=4096)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want),
                               **TOL)


def test_flash_attention_takes_strided_views():
    """The model hands [B, S, H, D] tensors over transposed, without a copy:
    the plain version gives the same result as on contiguous copies."""
    q, k, v = _attn_inputs(9, 2, 4, 2, 20, 20, 16)
    qs, ks, vs = [x.transpose(1, 2).contiguous().transpose(1, 2)
                  for x in _t(q, k, v)]
    assert not qs.is_contiguous()
    got = K.flash_attention(qs, ks, vs, causal=True, window=5)
    want = K.flash_attention(*_t(q, k, v), causal=True, window=5)
    assert torch.equal(got, want)


def test_flash_attention_rejects_bad_operands():
    q, k, v = _t(*_attn_inputs(1, 1, 4, 2, 8, 8, 16))
    with pytest.raises(ValueError):
        K.flash_attention(q, k[:, :1], v, causal=True)
    with pytest.raises(ValueError):
        K.flash_attention(q, torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16))
    with pytest.raises(TypeError):
        K.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError):
        K.flash_attention(q[0], k, v)


# ---------------------------------------------------------------------------
# flash_decode
# ---------------------------------------------------------------------------

def _decode_inputs(seed, b, hq, hkv, t, d, special=False):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, hq, d).astype(np.float32)
    k = rng.randn(b, t, hkv, d).astype(np.float32)
    v = rng.randn(b, t, hkv, d).astype(np.float32)
    mask = rng.rand(b, t) > 0.4
    if special:
        mask[0] = False                 # no live key: the uniform mean
        mask[1] = False
        mask[1, t // 2] = True          # one live key: its value row
    return q, k, v, mask


# b, hq, hkv, t, d, block_k of the Pallas kernel
DECODE_SHAPES = [(2, 4, 2, 128, 16, 32), (1, 8, 1, 256, 32, 64),
                 (3, 4, 4, 64, 24, 32), (2, 8, 2, 96, 8, 32)]


@pytest.mark.parametrize("shp", DECODE_SHAPES,
                         ids=lambda s: "-".join(map(str, s)))
def test_flash_decode_matches_pallas_interpret(shp):
    *dims, bk = shp
    q, k, v, mask = _decode_inputs(sum(shp), *dims)
    want = np.asarray(pallas_decode(*_j(q, k, v, mask), block_k=bk,
                                    interpret=True))
    got = K.flash_decode(*_t(q, k, v, mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


ORACLE_DECODE = [(2, 4, 2, 1, 16), (3, 4, 1, 37, 24), (2, 8, 8, 100, 8),
                 (4, 8, 2, 300, 16), (2, 6, 3, 5, 40)]


@pytest.mark.parametrize("special", [False, True])
@pytest.mark.parametrize("shp", ORACLE_DECODE,
                         ids=lambda s: "-".join(map(str, s)))
def test_flash_decode_matches_jax_oracle(shp, special):
    q, k, v, mask = _decode_inputs(sum(shp) + 2, *shp,
                                   special=special and shp[0] > 1)
    want = np.asarray(jref.flash_decode_ref(*_j(q, k, v, mask)))
    got = K.flash_decode(*_t(q, k, v, mask))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if special and shp[0] > 1:
        b, hq, hkv, t, d = shp
        g = hq // hkv
        mean = np.repeat(v[0].mean(0), g, axis=0)        # all-masked row
        np.testing.assert_allclose(got.numpy()[0], mean, atol=1e-5,
                                   rtol=1e-4)
        one = np.repeat(v[1, t // 2], g, axis=0)          # one live key
        np.testing.assert_allclose(got.numpy()[1], one, atol=1e-5, rtol=1e-4)


def test_flash_decode_bf16_casts_probabilities():
    q, k, v, mask = _decode_inputs(5, 2, 8, 2, 64, 16)
    tq, tk, tv, tm = _t(q, k, v, mask)
    got = K.flash_decode(tq.to(torch.bfloat16), tk.to(torch.bfloat16),
                         tv.to(torch.bfloat16), tm)
    assert got.dtype == torch.bfloat16
    jq, jk, jv, jm = _j(q, k, v, mask)
    want = jref.flash_decode_ref(jq.astype(jnp.bfloat16),
                                 jk.astype(jnp.bfloat16),
                                 jv.astype(jnp.bfloat16), jm)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **TOL_BF16)


def test_flash_decode_rejects_bad_operands():
    q, k, v, mask = _t(*_decode_inputs(1, 2, 4, 2, 8, 16))
    with pytest.raises(ValueError):
        K.flash_decode(q, k, v, mask[:, :-1])
    with pytest.raises(ValueError):
        K.flash_decode(q[:, :3], k, v, mask)
    with pytest.raises(TypeError):
        K.flash_decode(q, k.to(torch.bfloat16), v, mask)
    with pytest.raises(ValueError):
        K.flash_decode(q[0], k, v, mask)


# ---------------------------------------------------------------------------
# the layer functions that reach them
# ---------------------------------------------------------------------------

def test_attention_core_is_causal_sdpa_with_window():
    """``layers.attention_core`` = the JAX package's ``sdpa`` under
    ``causal_mask(s, s, window)``, GQA by index."""
    from repro.models import layers as JL
    from repro_torch.configs import get_config

    cfg = get_config("h2o-danube-3-4b").reduced()
    rng = np.random.RandomState(3)
    q = rng.randn(2, 50, 4, 16).astype(np.float32)
    k = rng.randn(2, 50, 1, 16).astype(np.float32)
    v = rng.randn(2, 50, 1, 16).astype(np.float32)
    want = JL.sdpa(jnp.asarray(q), JL.repeat_kv(jnp.asarray(k), 4),
                   JL.repeat_kv(jnp.asarray(v), 4),
                   JL.causal_mask(50, 50, cfg.sliding_window))
    got = TL.attention_core(cfg, *_t(q, k, v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
