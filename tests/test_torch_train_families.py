"""Training of the SSM, hybrid, encoder-decoder and VLM families of the port
against the JAX package on the CPU (reduced mamba2-130m, zamba2-2.7b,
whisper-medium and llama-3.2-vision-90b, fp32).

The same weights (drawn by the JAX package, carried across with
``params_from_numpy``), the same numpy batches (``SyntheticSource`` tokens,
frames and image embeddings from a seeded ``RandomState``) through both:

* ``loss`` and every gradient leaf against ``jax.value_and_grad`` of JAX's
  ``loss``, mapped to the JAX layout (``models.layout.jax_tree``): the loss
  within 1e-5, each leaf within 1e-5 of its largest entry plus 1e-5
  relative (the tolerances of ``tests/test_torch_train.py``). The VLM runs
  at 4 layers (two groups), its gates set from a seed on both sides: they
  start at 0, and so would every cross weight's gradient. Every attention
  weight's gradient, the cross layers' and the gates' included, is
  nonzero. The sequence (40) is not a multiple of the SSD's chunk (16), so
  the padding and the inter-chunk loop both run.
* ``segsum``'s gradient (``-inf`` above the diagonal, then ``exp``) against
  JAX's: finite, 0 above the diagonal.
* remat on equal to off (the same loss, the gradients within 1e-6).
* three ``make_train_step`` steps (AdamW, warmup-cosine, clipping), with
  microbatches 1 and 2, against JAX's: ``loss`` within 1e-5 and
  ``grad_norm`` within 1e-4 (relative), ``lr`` exactly, the final
  parameters with no entry past 1e-3; and each of the port's steps taken
  again from JAX's state before it (parameters and AdamW moments), its
  parameters leaf by leaf with no entry past 1e-3 and at most 0.1 % past
  1e-5, as ``tests/test_torch_train.py`` holds the dense and MoE families.
  The share is taken step by step because over three free-running steps
  at lr 1e-2 the VLM's parameters part further (166 entries past 1e-5,
  6 in one 2048-entry leaf) while every step taken from the same state
  stays within the rule: Adam's first step of an entry is
  ``lr * g / (|g| + eps)``, so the 1e-7 relative noise of the two
  backward passes moves the entries whose gradients are near zero by a
  part of lr, and the next steps' gradients, taken at parameters that
  differ there, differ elsewhere.
* the VLM without media: its loss equal to JAX's (each cross layer is then
  gated causal self-attention without rotary, as the reference computes
  it); whisper without media: refused on both sides (the port's
  ``ValueError`` "takes media", JAX's ``KeyError``).
* weight decay by the rank of the JAX layout (``jax_ndim``), leaf for leaf
  the JAX optimizer's ``ndim > 1``.
* the train state of each family written by either package and restored by
  the other, every leaf equal.
* the K3 calls (``FlashAttentionFunction``) and SSD calls a remat step
  makes, counted, equal to ``models.remat_calls``, the formulas
  ``chip_smoke.py`` holds the card's launch counters and the SSD's traced
  ranges to.
* ``launch.train`` trains the SSM, hybrid and VLM archs and refuses
  whisper-medium with "takes media".
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.models import mamba2 as JM
from repro.optim import AdamW as JAdamW
from repro.optim import warmup_cosine as jwarmup
from repro.train import init_train_state as jinit
from repro.train import make_train_step as jmake
from repro_torch import checkpoint as ckpt
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticSource
from repro_torch.kernels import FlashAttentionFunction
from repro_torch.models import (build_model, media_spec, needs_media,
                                remat_calls)
from repro_torch.models import mamba2 as TM
from repro_torch.models.layers import set_trainable
from repro_torch.models.layout import (from_jax_tree, jax_ndim, jax_tree,
                                       numpy_leaf)
from repro_torch.optim import AdamW, AdamWState, warmup_cosine
from repro_torch.train import TrainState, init_train_state, make_train_step

torch.set_num_threads(1)

ARCHS = {"ssm": "mamba2-130m", "hybrid": "zamba2-2.7b",
         "encdec": "whisper-medium", "vlm": "llama-3.2-vision-90b"}
FAMILIES = list(ARCHS)
SEQ, BATCH = 40, 4
# a gradient leaf of the port within this share of its largest entry (plus
# as much relative) of JAX's
GRAD_RTOL = 1e-5


def family_cfg(fam, get):
    """The reduced config of ``fam`` from ``get`` (either package's
    ``get_config``); the VLM at 4 layers, two groups of a self and a cross
    layer."""
    cfg = get(ARCHS[fam]).reduced()
    if fam == "vlm":
        cfg = dataclasses.replace(cfg, n_layers=4)
    return cfg


def seeded_gates(jparams, seed=7):
    """The JAX tree with every VLM gate drawn from ``seed`` (nonzero)."""
    if "cross_blocks" not in jparams:
        return jparams
    rng = np.random.RandomState(seed)
    cb = dict(jparams["cross_blocks"])
    for name in ("gate_attn", "gate_mlp"):
        cb[name] = jnp.asarray(rng.uniform(0.3, 1.2, cb[name].shape)
                               .astype(np.float32))
    return dict(jparams, cross_blocks=cb)


def _batch(cfg, step=0, media=True):
    """numpy tokens / labels at ``step`` and, for a family that takes them,
    media from a seeded ``RandomState``."""
    batch = SyntheticSource(DataConfig(SEQ, BATCH, cfg.vocab)).batch_at(step)
    if media and needs_media(cfg):
        rng = np.random.RandomState(100 + step)
        batch["media"] = rng.randn(*media_spec(cfg, BATCH)).astype(np.float32)
    return batch


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


_JAX = {}


def jax_family(fam):
    """(JAX model, its jitted ``value_and_grad`` of ``loss`` over (params,
    batch)) of ``fam``, made once."""
    if fam not in _JAX:
        jm = jbuild(family_cfg(fam, jget))
        _JAX[fam] = jm, jax.jit(jax.value_and_grad(
            lambda p, b: jm.loss(p, b, remat=False)))
    return _JAX[fam]


def _port(fam, jparams):
    cfg = family_cfg(fam, get_config)
    return params_from_numpy(jax.tree.map(np.asarray, jparams),
                             build_model(cfg, device="cpu", max_seq=SEQ))


@pytest.fixture(scope="module", params=FAMILIES)
def pair(request):
    """(family, JAX model, its params (gates seeded), the port's model on
    the same weights)."""
    fam = request.param
    jm, _ = jax_family(fam)
    jp = seeded_gates(jm.init(jax.random.key(3), SEQ))
    return fam, jm, jp, _port(fam, jp)


def _leaves(jtree, ttree):
    """(key, JAX leaf, port leaf) for every leaf of the JAX tree."""
    for path, leaf in jax.tree_util.tree_leaves_with_path(jtree):
        node = ttree
        for p in path:
            node = node[p.key]
        yield jax.tree_util.keystr(path), np.asarray(leaf), np.asarray(node)


def _grads(tm, batch, remat):
    set_trainable(tm)
    loss = tm.loss(_tb(batch), remat=remat)
    names, ps = zip(*tm.named_parameters())
    return loss, dict(zip(names, torch.autograd.grad(loss, ps)))


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


def _check_grads(fam, jp, tm, batch):
    jl, jg = jax_family(fam)[1](jp, _jb(batch))
    tl, tg = _grads(tm, batch, remat=False)
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=1e-5,
                               rtol=1e-5)
    tg = jax_tree(tg.items(), numpy_leaf)
    n = 0
    for key, want, got in _leaves(jg, tg):
        assert got.shape == want.shape, key
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(want).max(),
                                   err_msg=key)
        n += 1
    assert n == len(jax.tree.leaves(jp))
    return tg


def test_loss_and_gradients_match_jax(pair):
    fam, _, jp, tm = pair
    tg = _check_grads(fam, jp, tm, _batch(tm.cfg))
    # every attention weight (the cross layers' too), every mamba leaf and
    # the VLM's gates get a nonzero gradient
    for key, _, got in _leaves(jp, tg):
        if "attn" in key or "gate" in key or (
                fam in ("ssm", "hybrid") and "'blocks'" in key):
            assert np.abs(got).max() > 0, key
    if fam == "vlm":
        assert {k for k, _, _ in _leaves(jp, tg) if "cross_blocks" in k}


def test_vlm_loss_without_media_matches_jax():
    """Without media JAX's ``forward`` passes ``kv_x=None``: each cross layer
    is gated causal self-attention over the text, no rotary. The port
    computes the same, loss and every gradient leaf; the media change the
    loss."""
    jm, _ = jax_family("vlm")
    jp = seeded_gates(jm.init(jax.random.key(5), SEQ))
    tm = _port("vlm", jp)
    batch = _batch(tm.cfg, 2, media=False)
    assert "media" not in batch
    tg = _check_grads("vlm", jp, tm, batch)
    assert np.abs(tg["cross_blocks"]["attn"]["wq"]).max() > 0
    with torch.no_grad():
        with_media = tm.loss(_tb(_batch(tm.cfg, 2)))
        without = tm.loss(_tb(batch))
    assert float(with_media) != float(without)


def test_whisper_loss_without_media_is_refused_on_both_sides():
    jm, _ = jax_family("encdec")
    jp = jm.init(jax.random.key(1), SEQ)
    tm = _port("encdec", jp)
    batch = _batch(tm.cfg, media=False)
    with pytest.raises(KeyError):
        jm.loss(jp, _jb(batch))
    with pytest.raises(ValueError, match="takes media"):
        tm.loss(_tb(batch))
    with pytest.raises(ValueError, match="takes media"):
        tm.forward(torch.as_tensor(batch["tokens"]))


def test_segsum_gradient_matches_jax():
    """``exp(segsum(a))`` puts ``exp(-inf) = 0`` above the diagonal; the
    gradient there is 0, never NaN, and equals JAX's leaf for leaf."""
    rng = np.random.RandomState(4)
    a = -np.abs(rng.randn(2, 3, 16)).astype(np.float32)
    w = rng.randn(2, 3, 16, 16).astype(np.float32)
    want = jax.grad(lambda x: jnp.sum(jnp.exp(JM.segsum(x)) * w))(
        jnp.asarray(a))
    ta = torch.from_numpy(a).requires_grad_()
    (torch.exp(TM.segsum(ta)) * torch.from_numpy(w)).sum().backward()
    assert torch.isfinite(ta.grad).all()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_remat_matches_no_remat(pair):
    """Checkpointed layers (nested in zamba's and the VLM's groups) give
    the loss and the gradients of stored activations."""
    _, _, _, tm = pair
    batch = _batch(tm.cfg, 1)
    (l0, g0), (l1, g1) = (_grads(tm, batch, r) for r in (False, True))
    assert float(l0.detach()) == float(l1.detach())
    for name in g0:
        torch.testing.assert_close(g0[name], g1[name], atol=1e-7, rtol=1e-6,
                                   msg=name)


# ---------------------------------------------------------------------------
# the train step, weight decay, checkpoints
# ---------------------------------------------------------------------------


def _jax_state(fam, jm, jopt, n_hot=0, key=3):
    jst = jinit(jm, jopt, jax.random.key(key), SEQ, n_hot_experts=n_hot)
    return jst._replace(params=seeded_gates(jst.params))


def _port_state(model, jst):
    """JAX's train state ``jst`` (parameters, AdamW moments and step
    counts) loaded into ``model``: the port's ``TrainState`` of it."""
    set_trainable(params_from_numpy(jax.tree.map(np.asarray, jst.params),
                                    model))
    names = [n for n, _ in model.named_parameters()]

    def moments(tree):
        return {k: torch.tensor(np.array(v, dtype=np.float32))
                for k, v in from_jax_tree(jax.tree.map(np.asarray, tree),
                                          names).items()}
    return TrainState(model, AdamWState(int(jst.opt.step),
                                        moments(jst.opt.mu),
                                        moments(jst.opt.nu)), int(jst.step))


def _port_leaves(model):
    return jax_tree(model.named_parameters(), numpy_leaf)


_STEPPED = {}


def three_steps(fam, microbatches):
    """Three ``make_train_step`` steps of each package (AdamW under
    warmup-cosine, peak lr 1e-2) from the same weights on the same batches,
    and each of the port's steps taken again from JAX's state before it;
    made once a family and microbatch count: (JAX's state, the port's, each
    step's metrics (JAX, port), each step's parameters after it (JAX, the
    port's step from JAX's state))."""
    if (fam, microbatches) in _STEPPED:
        return _STEPPED[fam, microbatches]
    jm, _ = jax_family(fam)
    jopt = JAdamW(lr=jwarmup(1e-2, 1, 3))
    jst = _jax_state(fam, jm, jopt)
    jstep = jax.jit(jmake(jm, jopt, microbatches=microbatches))
    tm, twin = _port(fam, jst.params), _port(fam, jst.params)
    opt = AdamW(lr=warmup_cosine(1e-2, 1, 3))
    st = init_train_state(tm, opt, None)
    step = make_train_step(tm, opt, microbatches=microbatches)
    twin_step = make_train_step(twin, opt, microbatches=microbatches)
    mets, stepped = [], []
    for i in range(3):
        batch = _batch(tm.cfg, i)
        from_jax, _ = twin_step(_port_state(twin, jst), _tb(batch))
        jst, jmet = jstep(jst, _jb(batch))
        st, met = step(st, _tb(batch))
        mets.append((jmet, met))
        stepped.append((jst.params, _port_leaves(from_jax.model)))
    _STEPPED[fam, microbatches] = out = (jst, st, mets, stepped)
    return out


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("fam", FAMILIES)
def test_three_steps_match_jax(fam, microbatches):
    jst, st, mets, stepped = three_steps(fam, microbatches)
    for i, (jmet, met) in enumerate(mets):
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-4)
        assert float(met["lr"]) == float(jmet["lr"])
        assert met["step"] == int(jmet["step"]) == i + 1
    for key, want, got in _leaves(jst.params, _port_leaves(st.model)):
        assert np.abs(got - want).max() <= 1e-3, key
    # each step from the same state, leaf by leaf as in test_torch_train.py
    for i, (jparams, ported) in enumerate(stepped):
        for key, want, got in _leaves(jparams, ported):
            diff = np.abs(got - want)
            assert diff.max() <= 1e-3, (i, key, diff.max())
            assert (diff > 1e-5).mean() <= 1e-3, (
                i, key, int((diff > 1e-5).sum()), diff.size)


@pytest.mark.parametrize("fam", FAMILIES)
def test_weight_decay_by_the_rank_of_the_jax_leaf(fam):
    """The port decays a leaf where the JAX optimizer does (``ndim > 1`` of
    the JAX leaf): mamba's per-layer ``[H]`` leaves and whisper's position
    tables are decayed, zamba's shared norms and the VLM's ``[G]`` gates
    and ``ln_f`` are not."""
    jp = jbuild(family_cfg(fam, jget)).init(jax.random.key(0), SEQ)
    tm = build_model(family_cfg(fam, get_config), device="cpu", max_seq=SEQ)
    ranks = jax_tree(((n, jax_ndim(n, p.shape))
                      for n, p in tm.named_parameters()),
                     lambda v, stacked: v[0])
    decayed = set()
    for key, leaf, rank in _leaves(jp, ranks):
        assert (int(rank) > 1) == (leaf.ndim > 1), key
        if leaf.ndim > 1:
            decayed.add(key)
    want = {"ssm": ["['blocks']['A_log']", "['blocks']['norm']"],
            "hybrid": ["['blocks']['D']", "['blocks']['dt_bias']"],
            "encdec": ["['enc_pos']", "['dec_pos']"],
            "vlm": ["['cross_blocks']['ln1']['scale']"]}[fam]
    assert decayed.issuperset(want)
    assert "['ln_f']['scale']" not in decayed
    if fam == "hybrid":
        assert not {k for k in decayed if k.startswith("['shared']['ln")}
    if fam == "vlm":
        assert "['cross_blocks']['gate_attn']" not in decayed


def _assert_same(jstate, tstate):
    got = dict(ckpt.checkpoint._flatten(ckpt.checkpoint._host_tree(tstate)))
    want = jckpt.checkpoint._flatten(jstate)
    assert set(got) == set(want)
    for key, leaf in want.items():
        a = np.asarray(leaf)
        assert got[key].dtype == a.dtype, key
        np.testing.assert_array_equal(got[key], a, err_msg=key)


@pytest.mark.parametrize("fam", FAMILIES)
def test_train_state_crosses_both_ways(tmp_path, fam):
    """After ``three_steps`` (microbatches 1) the port's state written and
    restored by JAX's ``restore``, JAX's written and restored by the
    port's: every leaf equal (mamba's tree has no head leaf,
    zamba's ``shared/``, whisper's two stacks and position tables, the
    VLM's ``cross_blocks/``)."""
    jst, st, _, _ = three_steps(fam, 1)
    fresh_j = jinit(jax_family(fam)[0], JAdamW(lr=1e-3), jax.random.key(9),
                    SEQ)
    fresh_t = init_train_state(
        build_model(family_cfg(fam, get_config), device="cpu", max_seq=SEQ),
        AdamW(lr=1e-3), 9)
    ckpt.save(str(tmp_path / "port"), 3, st)
    back_j = jckpt.restore(str(tmp_path / "port"), fresh_j)
    _assert_same(back_j, st)
    assert int(back_j.step) == 3 and int(back_j.opt.step) == 3
    jckpt.save(str(tmp_path / "jax"), 3, jst)
    back_t = ckpt.restore(str(tmp_path / "jax"), fresh_t)
    assert back_t.model is fresh_t.model and back_t.step == 3
    _assert_same(jst, back_t)
    tree = jax_tree(back_t.model.named_parameters(), numpy_leaf)
    assert ("head" in tree["embed"]) == (fam != "ssm")
    assert {"ssm": "blocks", "hybrid": "shared", "encdec": "dec_blocks",
            "vlm": "cross_blocks"}[fam] in tree


# ---------------------------------------------------------------------------
# K3 calls under remat, and the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fam,media", [(f, True) for f in FAMILIES]
                         + [("vlm", False)])
def test_k3_calls_under_remat(fam, media, monkeypatch):
    tm = build_model(family_cfg(fam, get_config), device="cpu",
                     max_seq=SEQ).init(0)
    opt = AdamW(lr=1e-3)
    st = init_train_state(tm, opt, None)
    step = make_train_step(tm, opt, microbatches=2)
    seen = dict.fromkeys(("flash_attention", "flash_attention_bwd",
                          "ssd_chunked"), 0)

    def counted(name, fn):
        def run(*args, **kw):
            seen[name] += 1
            return fn(*args, **kw)
        return run
    monkeypatch.setattr(FlashAttentionFunction, "forward", staticmethod(
        counted("flash_attention", FlashAttentionFunction.forward)))
    monkeypatch.setattr(FlashAttentionFunction, "backward", staticmethod(
        counted("flash_attention_bwd", FlashAttentionFunction.backward)))
    monkeypatch.setattr(TM, "ssd_chunked",
                        counted("ssd_chunked", TM.ssd_chunked))
    step(st, _tb(_batch(tm.cfg, media=media)))
    assert seen == {k: 2 * n for k, n in remat_calls(tm.cfg).items()}


@pytest.mark.parametrize("fam", FAMILIES)
def test_launch_train(fam, tmp_path, capsys):
    """``launch.train`` trains the SSM, hybrid and VLM archs (the VLM's
    batches carry no media, as the JAX launcher's) and resumes; whisper
    refuses, as the JAX launcher does (its ``KeyError`` on ``media``)."""
    from repro_torch.launch import train

    argv = ["--arch", ARCHS[fam], "--device", "cpu", "--steps", "2",
            "--seq", "16", "--batch", "4", "--microbatches", "2",
            "--checkpoint-dir", str(tmp_path)]
    if fam == "encdec":
        with pytest.raises(ValueError, match="takes media"):
            train.main(argv)
        return
    res = train.main(argv)
    assert res["steps"] == 2 and np.isfinite(res["final_loss"])
    assert ckpt.latest_step(str(tmp_path)) == 2
    assert train.main(argv[:-2] + ["--steps", "3", "--checkpoint-dir",
                                   str(tmp_path)])["steps"] == 1
