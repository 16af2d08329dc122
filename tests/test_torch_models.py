"""Per-arch smoke and consistency tests of the port: the twin of
``tests/test_models.py`` over all ten archs, plus each arch's ``forward``
held against the JAX package's.

Every arch runs its REDUCED config on the CPU, fp32, on the JAX package's
weights (carried across with ``params_from_numpy``), tokens and media from
a seeded numpy ``RandomState``. The VLM's gates start at zero in both
packages, which takes its cross layers out of every output, so they are set
from a seed on both sides (the JAX twin keeps them at zero):

* ``loss`` and ``forward``: shapes and finite values;
* one ``make_train_step`` step: the step counted, a finite loss, a nonzero
  gradient norm;
* ``forward``'s logits against JAX's ``forward`` on the same inputs, within
  atol 1e-5, rtol 1e-4 (two fp32 sums in their own orders);
* prefill then one decode step against the port's own ``forward`` (the
  serving invariant), within 1e-4 as in the JAX twin;
* two prefill chunks against a one-shot prefill, within 1e-4.

The MoE archs run with capacity 100 (nothing dropped) where a path's token
count decides the capacity, as the JAX twin does.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import build_model, media_spec, needs_media
from repro_torch.optim import AdamW
from repro_torch.train import init_train_state, make_train_step

torch.set_num_threads(1)

ALL_ARCHS = sorted(ARCHS)
B, S, MAX_SEQ = 2, 32, 64
_CACHE = {}


def _setup(arch, no_drop=False):
    """(cfg, the JAX model and params, the port's model on them, tokens,
    media or None), made once an arch and variant."""
    if (arch, no_drop) in _CACHE:
        return _CACHE[arch, no_drop]
    cfgs = [get(arch).reduced() for get in (jget, get_config)]
    if no_drop and cfgs[0].n_experts:
        cfgs = [dataclasses.replace(c, capacity_factor=100.0) for c in cfgs]
    jm = jbuild(cfgs[0])
    jp = jm.init(jax.random.key(0), MAX_SEQ)
    if "cross_blocks" in jp:
        rng = np.random.RandomState(7)
        jp["cross_blocks"] = {
            **jp["cross_blocks"],
            **{g: rng.uniform(0.3, 1.2, jp["cross_blocks"][g].shape)
               .astype(np.float32) for g in ("gate_attn", "gate_mlp")}}
    tm = params_from_numpy(jax.tree.map(np.asarray, jp),
                           build_model(cfgs[1], device="cpu",
                                       max_seq=MAX_SEQ))
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, cfgs[1].vocab, (B, S)).astype(np.int64)
    media = None
    if needs_media(cfgs[1]):
        media = rng.randn(*media_spec(cfgs[1], B)).astype(np.float32)
    _CACHE[arch, no_drop] = out = (cfgs[1], jm, jp, tm, tokens, media)
    return out


def _forward(model, tokens, media, params=None):
    """``forward`` with media where the arch takes them (either package:
    the JAX model with ``params``)."""
    args = (tokens,) if media is None else (tokens, media)
    if params is not None:
        return model.forward(params, *args)
    with torch.no_grad():
        return model.forward(*(torch.as_tensor(a) for a in args))


def _kw(media):
    return {} if media is None else {"media": torch.as_tensor(media)}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_smoke_forward_shapes_and_finiteness(arch):
    cfg, _, _, tm, tokens, media = _setup(arch)
    batch = {"tokens": torch.as_tensor(tokens),
             "labels": torch.as_tensor(tokens), **_kw(media)}
    with torch.no_grad():
        loss = tm.loss(batch)
    assert loss.shape == () and bool(torch.isfinite(loss)), arch
    logits = _forward(tm, tokens, media)
    assert logits.shape == (B, S, cfg.vocab)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_smoke_one_train_step(arch):
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu", max_seq=MAX_SEQ)
    opt = AdamW(lr=1e-3)
    n_hot = 2 if cfg.n_experts else 0
    state = init_train_state(model, opt, 0, n_hot)
    step = make_train_step(model, opt, microbatches=1, n_hot_experts=n_hot)
    _, _, _, _, tokens, media = _setup(arch)
    batch = {"tokens": torch.as_tensor(tokens),
             "labels": torch.as_tensor(tokens), **_kw(media)}
    state, metrics = step(state, batch)
    assert state.step == 1
    assert bool(torch.isfinite(metrics["loss"]))
    assert float(metrics["grad_norm"]) > 0


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_forward_matches_jax(arch):
    _, jm, jp, tm, tokens, media = _setup(arch)
    want = _forward(jm, tokens, media, jp)
    got = _forward(tm, tokens, media)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_prefill_decode_consistency(arch):
    """decode(prefill(prompt)) logits == the parallel forward's."""
    _, _, _, tm, tokens, media = _setup(arch, no_drop=True)
    full = _forward(tm, tokens, media)
    toks = torch.as_tensor(tokens)
    logits_pre, cache = tm.prefill(toks[:, :S - 1], MAX_SEQ, **_kw(media))
    lg_dec, _ = tm.decode_step(cache, toks[:, S - 1],
                               torch.full((B,), S - 1, dtype=torch.int64))
    torch.testing.assert_close(logits_pre, full[:, S - 2], atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(lg_dec, full[:, S - 1], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_chunked_prefill_equals_oneshot(arch):
    _, _, _, tm, tokens, media = _setup(arch, no_drop=True)
    toks, c = torch.as_tensor(tokens), 16
    with torch.no_grad():
        lg_ref, _ = tm.prefill(toks, MAX_SEQ, **_kw(media))
    cache = tm.init_cache(B, MAX_SEQ, torch.float32)
    _, cache = tm.chunk_prefill(cache, toks[:, :c], 0, **_kw(media))
    lg, _ = tm.chunk_prefill(cache, toks[:, c:], c, **_kw(media))
    torch.testing.assert_close(lg, lg_ref, atol=1e-4, rtol=1e-4)
