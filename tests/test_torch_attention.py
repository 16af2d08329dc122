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


# ---------------------------------------------------------------------------
# the kernels' Python side: the split plan of flash_decode's clusters, the
# tensor maps of flash_attention's bf16 path, and what they refuse
# ---------------------------------------------------------------------------

import importlib  # noqa: E402

# the modules (the package exports the wrappers under the same names)
FA = importlib.import_module("repro_torch.kernels.flash_attention")
FD = importlib.import_module("repro_torch.kernels.flash_decode")

# sms, b, hkv, g, t, elem_size, d: the lanes slice on an H100 (132 SMs),
# head_dim 64 and fp32, one (slot, head) over a long cache (8 splits), a
# 37-key cache (one split), many clusters (one split each), GQA group 32
# (two clusters of 16 rows per head), a card of 16 SMs
SPLIT_CASES = [(132, 8, 8, 4, 4096, 2, 120), (132, 8, 8, 4, 4096, 2, 64),
               (132, 8, 8, 4, 4096, 4, 120), (132, 1, 1, 4, 1500, 2, 64),
               (132, 2, 4, 1, 37, 2, 120), (132, 64, 8, 4, 700, 2, 120),
               (132, 2, 1, 32, 300, 2, 64), (16, 4, 2, 4, 5000, 2, 128),
               (132, 3, 4, 1, 1, 4, 64), (132, 1, 1, 1, 128 * 8 + 1, 2, 64)]


@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_decode_split_plan_covers_every_key_once(case):
    sms, b, hkv, g, t, es, d = case
    n, kps = FD._splits(sms, b, hkv, g, t, es, d)
    assert 1 <= n <= FD.MAX_SPLIT
    assert kps % FD.tile_keys(es) == 0
    spans = [(i * kps, min(t, (i + 1) * kps)) for i in range(n)]
    assert all(lo < hi for lo, hi in spans)        # no empty split
    covered = np.zeros(t, np.int64)
    for lo, hi in spans:
        covered[lo:hi] += 1
    assert (covered == 1).all()
    # no more blocks than one wave of the card holds, unless one split each
    per_sm = max(1, FD._SMEM_PER_SM // (FD.smem_bytes(es, d) + 1024))
    clusters = b * hkv * -(-g // FD.BLOCK_ROWS)
    assert n == 1 or clusters * n <= per_sm * sms


def test_flash_decode_split_plan_at_the_slice_shape():
    """8 slots x 8 KV heads of 120 in bf16 on 132 SMs: one block fits an SM,
    so 2 splits of 2048 keys make 128 blocks, one wave; the plan depends on
    the SM count it is given, not on a card."""
    assert FD.smem_bytes(2, 120) <= 227 * 1024 < 2 * FD.smem_bytes(2, 120)
    assert FD._splits(132, 8, 8, 4, 4096, 2, 120) == (2, 2048)
    assert FD._splits(66, 8, 8, 4, 4096, 2, 120) == (1, 4096)
    assert FD._splits(264, 8, 8, 4, 4096, 2, 120) == (4, 1024)
    assert FD._splits(132, 1, 1, 4, 4096, 2, 120) == (8, 512)


@pytest.mark.parametrize("d,es,dp", [(16, 2, 64), (64, 2, 64), (120, 2, 128),
                                     (128, 2, 128), (64, 4, 64),
                                     (120, 4, 128)])
def test_flash_decode_smem_bytes(d, es, dp):
    """As ``Smem`` in the source. bf16: 3 stages of K and V in 64-column
    boxes of 128 rows x 128 bytes, 16 query rows padded by 16 bytes, a code
    byte per key and a barrier per stage, a flag, 1 KB of alignment. fp32: 2
    stages of 64 keys with rows padded by 16 bytes, the query rows, codes
    and flag. Every block fits the 227 KB a block may use."""
    if es == 2:
        want = (2 * 3 * (dp // 64) * 128 * 128 + 16 * (dp + 8) * 2
                + 3 * 128 + 24 + 16 + 1024)
    else:
        want = 2 * 2 * 64 * (dp + 4) * 4 + 16 * (dp + 4) * 4 + 128 + 16 + 16
    assert FD.tile_keys(es) == (128 if es == 2 else 64)
    assert FD.smem_bytes(es, d) == want <= 227 * 1024


def test_flash_decode_kernel_plan_refuses_what_the_kernel_does_not_take():
    def ops(b=2, hq=4, hkv=2, t=64, d=16, dtype=torch.bfloat16):
        return (torch.zeros(b, hq, d, dtype=dtype),
                torch.zeros(b, t, hkv, d, dtype=dtype),
                torch.zeros(b, t, hkv, d, dtype=dtype))
    assert FD.kernel_plan(*ops(), 132) == (1, 128)
    with pytest.raises(ValueError):
        FD.kernel_plan(*ops(d=12), 132)            # not whole 16-byte pieces
    with pytest.raises(ValueError):
        FD.kernel_plan(*ops(d=136), 132)           # past 128
    with pytest.raises(ValueError):
        FD.kernel_plan(*ops(t=0), 132)             # an empty cache
    q, k, v = ops(d=32)
    with pytest.raises(ValueError):
        FD.kernel_plan(q, k[:, :, :, :16], v[:, :, :, :16], 132)  # strided
    q, k, v = ops()
    with pytest.raises(ValueError):                # 8-byte aligned
        FD.kernel_plan(q, k, torch.zeros(2 * 64 * 2 * 16 + 4,
                                         dtype=torch.bfloat16)[4:].view(
                                             2, 64, 2, 16), 132)
    # fp32 takes 4 values a piece
    assert FD.kernel_plan(*ops(d=4, dtype=torch.float32), 132)[0] == 1


@pytest.mark.parametrize("d,boxes", [(64, 1), (120, 2), (128, 2), (8, 1)])
def test_tensor_map_geometry_of_strided_views(d, boxes):
    """The model's [B, S, H, D] tensors seen as [B, H, S, D]: the map's
    dims are (D, S, H, B), its byte strides those of S, H and B, and its
    64-column boxes cover D."""
    b, s, h = 2, 37, 3
    x = torch.zeros(b, s, h, d, dtype=torch.bfloat16).transpose(1, 2)
    geo = FA.tensor_map_geometry(x)
    assert geo["dims"] == (d, s, h, b)
    assert geo["strides"] == (s * h * d, d, h * d)   # batch, head, row
    assert geo["byte_strides"] == (2 * h * d, 2 * d, 2 * s * h * d)
    assert geo["boxes"] == boxes
    assert all(st % 16 == 0 for st in geo["byte_strides"])


def test_tensor_map_geometry_extent_one_dims():
    """A dimension of extent 1 is never stepped: whatever stride PyTorch
    reports for it, the map gets one 16-byte unit."""
    x = torch.zeros(1, 5, 1, 64, dtype=torch.bfloat16).transpose(1, 2)
    geo = FA.tensor_map_geometry(x)
    assert geo["dims"] == (64, 5, 1, 1)
    assert geo["strides"] == (8, 8, 64)
    q = torch.zeros(1, 4, 1, 64, dtype=torch.bfloat16)
    assert FA.tensor_map_geometry(q)["strides"] == (8, 64, 8)


def test_tensor_map_geometry_refuses_what_a_map_cannot_take():
    base = torch.zeros(2, 4, 16, 24, dtype=torch.bfloat16)
    with pytest.raises(ValueError):               # row stride 12 values
        FA.tensor_map_geometry(torch.zeros(2, 4, 16, 12,
                                           dtype=torch.bfloat16)[..., :8])
    with pytest.raises(ValueError):               # pointer 8 bytes off
        FA.tensor_map_geometry(base[..., 4:12])
    with pytest.raises(ValueError):               # D not a multiple of 8
        FA.tensor_map_geometry(base[..., :20])
    with pytest.raises(ValueError):               # D past 128
        FA.tensor_map_geometry(torch.zeros(1, 1, 4, 136, dtype=torch.bfloat16))
    with pytest.raises(ValueError):               # a non-dense last dim
        FA.tensor_map_geometry(base.transpose(2, 3)[..., :8, :])
    with pytest.raises(ValueError):               # not a 16-bit tensor
        FA.tensor_map_geometry(torch.zeros(1, 1, 4, 16))
    assert FA.tensor_map_geometry(base[..., 8:16])["boxes"] == 1


def test_state_helpers_default_to_the_card():
    """The paged cache, the slot state and the sampling table are made on
    the card unless the caller asks for the CPU; without a card the default
    raises instead of falling back."""
    from repro_torch.kvcache import make_paged_kv
    from repro_torch.models.sampling import make_slot_params
    from repro_torch.serve import make_slots

    calls = [lambda **kw: make_paged_kv(1, 2, 2, 1, 1, 1, 8, **kw),
             lambda **kw: make_slots(3, **kw),
             lambda **kw: make_slot_params(3, **kw)]
    for call in calls:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError):
                call()
        state = call(device="cpu")
        tensors = (state.values() if isinstance(state, dict)
                   else [x for x in state if isinstance(x, torch.Tensor)])
        assert all(x.device.type == "cpu" for x in tensors)
