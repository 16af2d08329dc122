"""The SSM and hybrid families of the port against the JAX package:
``models/mamba2.py`` function by function and ``MambaLM`` / ``ZambaLM``
(reduced mamba2-130m: 2 layers, 4 SSD heads of 32, state 16, chunk 16;
reduced zamba2-2.7b: 4 layers, the shared block after every 2, 4 heads of
16), fp32 on the CPU.

The same numpy inputs (and the JAX package's weights, carried across with
``params_from_numpy``) go through both. Tolerance: atol 1e-5 and rtol 1e-4
(fp32: the two packages sum the einsums and the ``cumsum``\\ s in their own
orders), on outputs, logits and every cache leaf; ``segsum``'s ``-inf``
pattern is held exactly and ``exp(segsum)`` has no NaN.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.kvcache import paged as JPG
from repro.models import build_model as jbuild
from repro.models import mamba2 as JM
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import ARCHS, get_config
from repro_torch.kvcache import paged as TPG
from repro_torch.models import MambaLM, ZambaLM, build_model
from repro_torch.models import mamba2 as TM

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-4)
ARCH_NAMES = ("mamba2-130m", "zamba2-2.7b")


def T(a):
    return torch.from_numpy(np.array(a))


def close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL,
                               err_msg=what)


def _x(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


@pytest.fixture(scope="module", params=ARCH_NAMES)
def pair(request):
    """(JAX config, model, params; the port's model on the same weights)."""
    arch = request.param
    jcfg = jget(arch).reduced()
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.key(3), 32)
    tmodel = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               build_model(get_config(arch).reduced(),
                                           device="cpu"))
    return jcfg, jmodel, jparams, tmodel


@pytest.fixture(scope="module")
def mamba():
    """The reduced mamba2 pair and layer 0's parameters in both layouts."""
    jcfg = jget("mamba2-130m").reduced()
    jparams = jbuild(jcfg).init(jax.random.key(5), 32)
    tmodel = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               build_model(get_config("mamba2-130m").reduced(),
                                           device="cpu"))
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"])
    return jcfg, jp, tmodel.cfg, tmodel.blocks[0].params()


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_configs_equal_the_jax_package(arch):
    """Registered, resolved, and field for field the JAX config, full and
    reduced (the ``ssm_*`` fields and ``hybrid_attn_every`` among them)."""
    assert arch in ARCHS
    for mine, theirs in ((get_config(arch), jget(arch)),
                         (get_config(arch).reduced(), jget(arch).reduced())):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert (mine.d_inner, mine.ssm_heads, mine.resolved_head_dim) == (
            theirs.d_inner, theirs.ssm_heads, theirs.resolved_head_dim)
    full = get_config(arch)
    if arch == "zamba2-2.7b":
        # the shared block's heads are 2560 / 32 = 80 wide
        assert full.resolved_head_dim == 80 and full.n_layers // \
            full.hybrid_attn_every == 9


# ---------------------------------------------------------------------------
# mamba2 functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q", [16, 7])
def test_segsum(q):
    a = -np.abs(_x(0, 2, 3, q))
    got, want = TM.segsum(T(a)), JM.segsum(jnp.asarray(a))
    want = np.asarray(want)
    assert np.array_equal(np.isneginf(got.numpy()), np.isneginf(want))
    fin = np.isfinite(want)
    close(got.numpy()[fin], want[fin], "segsum")
    e = torch.exp(got)
    assert not torch.isnan(e).any()
    assert (e.numpy()[~fin] == 0).all()


def _ssd_inputs(seed, s, cfg):
    b, h, p, g, n = 2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, \
        cfg.ssm_state
    x = _x(seed, b, s, h, p)
    dt = np.log1p(np.exp(_x(seed + 1, b, s, h) - 2.0)).astype(np.float32)
    A = -np.linspace(1.0, 16.0, h).astype(np.float32)
    B = _x(seed + 2, b, s, g, n, scale=0.5)
    C = _x(seed + 3, b, s, g, n, scale=0.5)
    st = _x(seed + 4, b, h, p, n, scale=0.3)
    return x, dt, A, B, C, st


@pytest.mark.parametrize("s", [32, 21])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked(mamba, s, with_state):
    """A whole number of chunks (32 = 2 x 16) and not (21: zero padding
    with dt = 0), with and without ``init_state``."""
    _, _, cfg, _ = mamba
    x, dt, A, B, C, st = _ssd_inputs(10, s, cfg)
    init = st if with_state else None
    jy, jst = JM.ssd_chunked(*(jnp.asarray(v) for v in (x, dt, A, B, C)),
                             cfg.ssm_chunk,
                             None if init is None else jnp.asarray(init))
    ty, tst = TM.ssd_chunked(*(T(v) for v in (x, dt, A, B, C)),
                             cfg.ssm_chunk, None if init is None else T(init))
    assert ty.shape == (2, s) + x.shape[2:]
    close(ty, jy, "y")
    close(tst, jst, "final state")


def test_ssd_decode_step(mamba):
    _, _, cfg, _ = mamba
    x, dt, A, B, C, st = _ssd_inputs(20, 1, cfg)
    args = (x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], st)
    jy, jst = JM.ssd_decode_step(*(jnp.asarray(v) for v in args))
    ty, tst = TM.ssd_decode_step(*(T(v) for v in args))
    close(ty, jy, "y")
    close(tst, jst, "state")


@pytest.mark.parametrize("left", [False, True])
def test_causal_conv(mamba, left):
    _, jp, _, p = mamba
    xbc = _x(30, 2, 9, jp["conv_w"].shape[1])
    ctx = _x(31, 2, 3, xbc.shape[2]) if left else None
    want = JM.causal_conv(jnp.asarray(xbc), jp["conv_w"], jp["conv_b"],
                          None if ctx is None else jnp.asarray(ctx))
    got = TM.causal_conv(T(xbc), p["conv_w"], p["conv_b"],
                         None if ctx is None else T(ctx))
    close(got, want, "conv")


def test_conv_decode_step(mamba):
    _, jp, _, p = mamba
    ch = jp["conv_w"].shape[1]
    tail, x_t = _x(40, 2, 3, ch), _x(41, 2, ch)
    jo, jt = JM.conv_decode_step(jnp.asarray(tail), jnp.asarray(x_t),
                                 jp["conv_w"], jp["conv_b"])
    to, tt = TM.conv_decode_step(T(tail), T(x_t), p["conv_w"], p["conv_b"])
    close(to, jo, "out")
    assert np.array_equal(tt.numpy(), np.asarray(jt))


def test_gated_rmsnorm(mamba):
    _, jp, cfg, p = mamba
    y, z = _x(50, 2, 5, cfg.d_inner), _x(51, 2, 5, cfg.d_inner)
    scale = 1.0 + _x(52, cfg.d_inner, scale=0.1)
    close(TM.gated_rmsnorm(T(y), T(z), T(scale), cfg.norm_eps),
          JM.gated_rmsnorm(jnp.asarray(y), jnp.asarray(z),
                           jnp.asarray(scale), cfg.norm_eps), "norm")


@pytest.mark.parametrize("s", [19, 32])
def test_mamba_block(mamba, s):
    jcfg, jp, cfg, p = mamba
    u = _x(60, 2, s, cfg.d_model)
    want = JM.mamba_block(jcfg, jp, jnp.asarray(u))
    got = TM.mamba_block(cfg, p, T(u))
    for g, w, what in zip(got, want, ("out", "state", "conv tail")):
        close(g, w, what)


def test_mamba_block_chunk(mamba):
    jcfg, jp, cfg, p = mamba
    u = _x(70, 2, 5, cfg.d_model)
    st = _x(71, 2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, scale=0.3)
    tail = _x(72, 2, cfg.ssm_conv - 1, jp["conv_w"].shape[1])
    want = JM.mamba_block_chunk(jcfg, jp, jnp.asarray(u), jnp.asarray(st),
                                jnp.asarray(tail))
    got = TM.mamba_block_chunk(cfg, p, T(u), T(st), T(tail))
    for g, w, what in zip(got, want, ("out", "state", "conv tail")):
        close(g, w, what)


def test_mamba_decode_step(mamba):
    jcfg, jp, cfg, p = mamba
    u = _x(80, 2, cfg.d_model)
    st = _x(81, 2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, scale=0.3)
    tail = _x(82, 2, cfg.ssm_conv - 1, jp["conv_w"].shape[1])
    want = JM.mamba_decode_step(jcfg, jp, jnp.asarray(u), jnp.asarray(st),
                                jnp.asarray(tail))
    got = TM.mamba_decode_step(cfg, p, T(u), T(st), T(tail))
    for g, w, what in zip(got, want, ("out", "state", "conv tail")):
        close(g, w, what)


def test_init_mamba_state_and_block_init(mamba):
    jcfg, _, cfg, _ = mamba
    want = JM.init_mamba_state(jcfg, 3, jnp.float32)
    got = TM.init_mamba_state(cfg, 3, torch.float32)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert all(not v.any() for v in got.values())
    # the deterministic leaves of init_mamba_block, and the random ones'
    # scales
    jb = JM.init_mamba_block(jcfg, jax.random.key(0))
    blk = TM.MambaBlock(cfg, "cpu")
    blk.init_(cfg, torch.Generator().manual_seed(0))
    for k in ("A_log", "dt_bias", "D", "norm", "conv_b"):
        close(getattr(blk, k).detach(), jb[k], k)
    for k, scale in (("in_proj", cfg.d_model ** -0.5), ("conv_w", 0.1),
                     ("out_proj", cfg.d_inner ** -0.5)):
        assert getattr(blk, k).shape == jb[k].shape
        assert abs(float(getattr(blk, k).std()) / scale - 1) < 0.1, k


# ---------------------------------------------------------------------------
# MambaLM / ZambaLM
# ---------------------------------------------------------------------------


def _cache_close(tc, jc):
    assert sorted(tc) == sorted(jc)
    for k in jc:
        assert tuple(tc[k].shape) == tuple(jc[k].shape), k
        close(tc[k], jc[k], f"cache leaf {k}")


def test_model_class_and_cache_layout(pair):
    jcfg, jmodel, jparams, tmodel = pair
    want = ZambaLM if jcfg.family == "hybrid" else MambaLM
    assert type(tmodel) is want and tmodel.device.type == "cpu"
    jc = jmodel.init_cache(3, 32)
    tc = tmodel.init_cache(3, 32)
    assert {k: tuple(v.shape) for k, v in tc.items()} == {
        k: tuple(v.shape) for k, v in jc.items()}
    # forward / loss (training) are ported: logits [B, S, V] and the loss
    # equal to the JAX package's
    toks = _prompt(91, 1, 4)
    close(tmodel.forward(T(toks).long()).detach(),
          jmodel.forward(jparams, jnp.asarray(toks)), "forward logits")
    batch = {"tokens": toks, "labels": toks}
    close(float(tmodel.loss({k: T(v) for k, v in batch.items()})),
          float(jmodel.loss(jparams, {k: jnp.asarray(v)
                                      for k, v in batch.items()})), "loss")


def _prompt(seed, b, s):
    return np.random.RandomState(seed).randint(0, 256, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("s", [21, 16])
def test_prefill(pair, s):
    _, jmodel, jparams, tmodel = pair
    toks = _prompt(90, 2, s)
    jl, jc = jmodel.prefill(jparams, jnp.asarray(toks), 32)
    tl, tc = tmodel.prefill(T(toks).long(), 32)
    close(tl, jl, "logits")
    _cache_close(tc, jc)


def test_chunk_prefill(pair):
    """Chunks of 5 over a 21-token prompt from an empty cache, the cache
    carried through both packages chunk by chunk."""
    _, jmodel, jparams, tmodel = pair
    toks = _prompt(91, 2, 21)
    jc, tc = jmodel.init_cache(2, 32), tmodel.init_cache(2, 32)
    for s0 in range(0, 21, 5):
        jl, jc = jmodel.chunk_prefill(jparams, jc,
                                      jnp.asarray(toks[:, s0:s0 + 5]), s0)
        tl, tc = tmodel.chunk_prefill(tc, T(toks[:, s0:s0 + 5]).long(), s0)
        close(tl, jl, f"logits at chunk {s0}")
        _cache_close(tc, jc)


def test_decode_step(pair):
    """Three decode steps after a prefill; slots at different positions
    (the shared block's KV rows land at each slot's own position)."""
    _, jmodel, jparams, tmodel = pair
    toks = _prompt(92, 2, 13)
    jl, jc = jmodel.prefill(jparams, jnp.asarray(toks), 32)
    tl, tc = tmodel.prefill(T(toks).long(), 32)
    pos = np.asarray([13, 17], np.int32)
    for _ in range(3):
        tok = np.asarray(jnp.argmax(jl, -1), np.int32)
        jl, jc = jmodel.decode_step(jparams, jc, jnp.asarray(tok),
                                    jnp.asarray(pos))
        tl, tc = tmodel.decode_step(tc, T(tok).long(), T(pos).long())
        close(tl, jl, "logits")
        _cache_close(tc, jc)
        pos = pos + 1


def test_decode_write_mask_drops_only_kv(pair):
    """``write_mask`` False leaves a slot's KV lanes untouched and its
    recurrent state advancing (slot-private, as in the JAX lanes path)."""
    _, _, _, tmodel = pair
    toks = T(_prompt(93, 2, 9)).long()
    _, c = tmodel.prefill(toks, 32)
    before = {k: v.clone() for k, v in c.items()}
    tmodel.decode_step(c, toks[:, -1], torch.tensor([9, 9]),
                       write_mask=torch.tensor([True, False]))
    assert not torch.equal(c["ssm"][:, 1], before["ssm"][:, 1])
    if "k" in c:
        assert torch.equal(c["k"][:, 1], before["k"][:, 1])
        assert not torch.equal(c["k"][:, 0, 9], before["k"][:, 0, 9])


def test_params_from_numpy_checks_the_layer_axis(pair):
    _, _, jparams, tmodel = pair
    tree = jax.tree.map(np.asarray, jparams)
    tree["blocks"]["in_proj"] = tree["blocks"]["in_proj"][:1]
    with pytest.raises(ValueError, match="in_proj"):
        params_from_numpy(tree, tmodel)


# ---------------------------------------------------------------------------
# the recurrent draft's snapshot rollback
# ---------------------------------------------------------------------------


def test_snapshot_stack_and_select_equal_jax():
    """k + 2 = 5 snapshots of a two-leaf lanes cache (batch on axis 1),
    each slot rolled back to its own index."""
    snaps = [{"ssm": _x(100 + i, 3, 4, 2, 5), "conv": _x(200 + i, 3, 4, 6)}
             for i in range(5)]
    idx = np.asarray([0, 4, 2, 1], np.int32)
    want = JPG.select_snapshot(
        JPG.snapshot_stack([jax.tree.map(jnp.asarray, s) for s in snaps]),
        jnp.asarray(idx))
    stacked = TPG.snapshot_stack([{k: T(v) for k, v in s.items()}
                                  for s in snaps])
    assert {k: tuple(v.shape) for k, v in stacked.items()} == {
        "ssm": (5, 3, 4, 2, 5), "conv": (5, 3, 4, 6)}
    got = TPG.select_snapshot(stacked, T(idx))
    for k in want:
        assert got[k].is_contiguous()
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    # a snapshot is a copy: the in-place cache may move on after it
    live = {k: T(v) for k, v in snaps[0].items()}
    snap = TPG.snapshot(live)
    live["ssm"].add_(1.0)
    assert np.array_equal(snap["ssm"].numpy(), snaps[0]["ssm"])
