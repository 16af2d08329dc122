"""Training of the port against the JAX package on the CPU (reduced
stablelm-1.6b and granite-moe-3b-a800m, fp32), and twins of
``tests/test_train.py``.

The same weights (drawn by the JAX package, carried across with
``params_from_numpy``) and the same numpy batches through both:

* ``loss`` and every gradient leaf, mapped to the JAX layout
  (``models.layout.jax_tree``: the per-layer gradients stacked as JAX
  stacks its blocks), dense and MoE in the staged, direct and adaptive
  dispatch modes: the loss within 1e-5, each gradient leaf within 1e-5 of
  its largest entry plus 1e-5 relative (two fp32 CPU backward passes that
  sum in another order; measured: about 2e-6 of the largest entry);
* three ``make_train_step`` steps (AdamW, warmup-cosine, clipping) with
  microbatches 1 and 2, dense and MoE in all three modes, against JAX's: ``loss``, ``grad_norm`` within 1e-4
  relative, ``lr`` exactly, ``expert_counts`` and ``hot_mask`` exactly,
  the parameters leaf by leaf with at most 0.1 % of the entries past 1e-5
  and none past 1e-3. Adam divides each gradient entry by its own running
  RMS, so an entry whose gradient is near zero turns the 1e-6 relative
  noise of the two backward passes into a visible part of a step (at lr
  1e-2 a step moves an entry up to 1e-2; measured: at most 10 entries of a
  65536-entry leaf past 1e-5, the largest 3.2e-4);
* ``AdamW.update`` alone on the same gradients: op for op, within 1e-6.

Twins of ``tests/test_train.py``: loss descent, grad accumulation, resume
from a checkpoint (bit for bit on the CPU, the continued run too), a fault
retried (the state left as it was, the run equal to one without the fault),
a fault that exhausts the retries, stragglers, the MoE hot mask and the
schedule. Remat on against off (the same losses and gradients), and serving
after training equal to a model loaded fresh from the trained parameters
(the cached compute-type copies dropped after each step).
"""
import dataclasses
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.optim import AdamW as JAdamW
from repro.optim import warmup_cosine as jwarmup
from repro.train import init_train_state as jinit
from repro.train import make_train_step as jmake
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, Pipeline, SyntheticSource
from repro_torch.models import build_model
from repro_torch.models.layers import set_trainable
from repro_torch.models.layout import jax_tree, numpy_leaf
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.train import (Trainer, TrainerConfig, init_train_state,
                               make_train_step)

torch.set_num_threads(1)

DENSE, MOE = "stablelm-1.6b", "granite-moe-3b-a800m"
SEQ, BATCH = 32, 8


def _leaves(jtree, ttree):
    """(key, JAX leaf, port leaf) for every leaf of the JAX tree."""
    for path, leaf in jax.tree_util.tree_leaves_with_path(jtree):
        node = ttree
        for p in path:
            node = node[p.key]
        yield jax.tree_util.keystr(path), np.asarray(leaf), np.asarray(node)


def _pair(arch, mode=None, key=3):
    """The JAX model and params, and the port's model with those weights."""
    kw = {"dispatch_mode": mode} if mode else {}
    jm = jbuild(jget(arch).reduced(), **kw)
    jp = jm.init(jax.random.key(key), SEQ)
    tm = params_from_numpy(jax.tree.map(np.asarray, jp),
                           build_model(get_config(arch).reduced(),
                                       device="cpu", **kw))
    return jm, jp, tm


def _batch(vocab, step=0):
    return SyntheticSource(DataConfig(SEQ, BATCH, vocab)).batch_at(step)


HOT = np.array([False, True, False, False, True, False, False, False])


@pytest.fixture(scope="module")
def dense():
    return _pair(DENSE)


@pytest.fixture(scope="module")
def moe():
    return _pair(MOE)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which,mode", [("dense", None), ("moe", "staged"),
                                        ("moe", "direct"),
                                        ("moe", "adaptive")])
def test_loss_and_gradients_match_jax(which, mode, request):
    jm, jp, tm = request.getfixturevalue(which)
    batch = _batch(tm.cfg.vocab)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    kw, tkw = {}, {}
    if mode:
        kw = dict(hot_mask=jnp.asarray(HOT), mode=mode)
        tkw = dict(hot_mask=torch.from_numpy(HOT), mode=mode)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb, remat=False, **kw)))(jp)
    set_trainable(tm)
    tl = tm.loss(batch, remat=False, **tkw)
    names, ps = zip(*tm.named_parameters())
    tg = jax_tree(zip(names, torch.autograd.grad(tl, ps)), numpy_leaf)
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=1e-5,
                               rtol=1e-5)
    n = 0
    for key, want, got in _leaves(jg, tg):
        assert got.shape == want.shape, key
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=key)
        n += 1
    assert n == len(jax.tree.leaves(jp))
    # every attention and expert weight gets a nonzero gradient
    for key, _, got in _leaves(jg, tg):
        if "attn" in key or "moe" in key:
            assert np.abs(got).max() > 0, key


def test_remat_matches_no_remat(moe):
    """Checkpointed layers (recomputed in the backward) give the same loss
    and gradients as stored activations."""
    _, _, tm = moe
    set_trainable(tm)
    batch = _batch(tm.cfg.vocab, 1)
    names, ps = zip(*tm.named_parameters())
    out = []
    for remat in (False, True):
        loss = tm.loss(batch, remat=remat, hot_mask=torch.from_numpy(HOT),
                       mode="adaptive")
        out.append((loss, torch.autograd.grad(loss, ps)))
    assert float(out[0][0]) == float(out[1][0])
    for name, a, b in zip(names, out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6, msg=name)


# ---------------------------------------------------------------------------
# the optimizer and the train step
# ---------------------------------------------------------------------------


def test_adamw_update_matches_jax_op_for_op():
    """The same gradients into both optimizers, three updates with
    clipping, weight decay and the schedule: parameters and moments within
    1e-6, grad_norm and lr within 1e-6 relative."""
    rs = np.random.RandomState(5)
    shapes = {"blocks.0.attn.wq": (6, 2, 3), "blocks.1.attn.wq": (6, 2, 3),
              "blocks.0.ln1.scale": (6,), "blocks.1.ln1.scale": (6,),
              "ln_f.scale": (6,), "embed.tok": (10, 6)}
    params = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rs.randn(*s) * 3).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    jo = JAdamW(lr=jwarmup(1e-2, 1, 3), weight_decay=0.1, clip_norm=1.0)
    to = AdamW(lr=warmup_cosine(1e-2, 1, 3), weight_decay=0.1, clip_norm=1.0)

    def jt(d):
        return jax.tree.map(jnp.asarray, jax_tree(d.items(), numpy_leaf))
    jp = jt(params)
    js = jo.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = to.init(tp)
    for g in grads:
        jp, js, jmet = jo.update(jt(g), js, jp)
        ts, tmet = to.update({k: torch.from_numpy(v) for k, v in g.items()},
                             ts, tp)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-6)
    for tree, jtree in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        for key, want, got in _leaves(jtree, jax_tree(tree.items(),
                                                      numpy_leaf)):
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6,
                                       err_msg=key)


@pytest.mark.parametrize("arch,mode,microbatches", [
    (DENSE, None, 1), (DENSE, None, 2), (MOE, "staged", 1),
    (MOE, "direct", 1), (MOE, "adaptive", 2)])
def test_three_steps_match_jax(arch, mode, microbatches):
    kw = {"dispatch_mode": mode} if mode else {}
    n_hot = 2 if mode else 0
    jcfg = jget(arch).reduced()
    jm = jbuild(jcfg, **kw)
    jopt = JAdamW(lr=jwarmup(1e-2, 1, 3))
    jst = jinit(jm, jopt, jax.random.key(3), SEQ, n_hot_experts=n_hot)
    jstep = jax.jit(jmake(jm, jopt, microbatches=microbatches,
                          n_hot_experts=n_hot))
    tm = params_from_numpy(jax.tree.map(np.asarray, jst.params),
                           build_model(get_config(arch).reduced(),
                                       device="cpu", **kw))
    opt = AdamW(lr=warmup_cosine(1e-2, 1, 3))
    st = init_train_state(tm, opt, None, n_hot)
    step = make_train_step(tm, opt, microbatches=microbatches,
                           n_hot_experts=n_hot)
    if n_hot:
        assert np.array_equal(st.hot_mask.numpy(), np.asarray(jst.hot_mask))
    for i in range(3):
        batch = _batch(jcfg.vocab, i)
        jst, jmet = jstep(jst, {k: jnp.asarray(v) for k, v in batch.items()})
        st, met = step(st, {k: torch.as_tensor(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-4)
        assert float(met["lr"]) == float(jmet["lr"])
        assert met["step"] == int(jmet["step"]) == i + 1
        if n_hot:
            assert np.array_equal(st.expert_counts.numpy(),
                                  np.asarray(jst.expert_counts))
            assert np.array_equal(st.hot_mask.numpy(),
                                  np.asarray(jst.hot_mask))
    for key, want, got in _leaves(jst.params,
                                  jax_tree(tm.named_parameters(),
                                           numpy_leaf)):
        diff = np.abs(got - want)
        assert diff.max() <= 1e-3, (key, diff.max())
        assert (diff > 1e-5).mean() <= 1e-3, (key, int((diff > 1e-5).sum()))


# ---------------------------------------------------------------------------
# twins of tests/test_train.py
# ---------------------------------------------------------------------------


def _setup(arch=DENSE, microbatches=1, n_hot=0, seed=0):
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    opt = AdamW(lr=1e-3)
    state = init_train_state(model, opt, seed, n_hot_experts=n_hot)
    step = make_train_step(model, opt, microbatches=microbatches,
                           n_hot_experts=n_hot)
    dc = DataConfig(seq_len=SEQ, global_batch=BATCH, vocab=cfg.vocab)
    return cfg, model, opt, state, step, dc


def _param0(state):
    return next(iter(state.model.parameters())).detach().clone()


def test_loss_decreases():
    """25 steps lower the loss on a batch the run never trains on. (The
    JAX twin compares the last step's loss with the first's; on these
    random tokens one batch's loss varies by about 0.05 from the next, as
    much as 25 steps move it, so the twin holds one batch fixed.)"""
    cfg, model, opt, state, step, dc = _setup()
    held = {k: torch.as_tensor(v)
            for k, v in SyntheticSource(dc).batch_at(1000).items()}
    with torch.no_grad():
        before = float(model.loss(held))
    tr = Trainer(step, state, Pipeline(SyntheticSource(dc)),
                 TrainerConfig(total_steps=25, log_every=100))
    res = tr.run()
    assert res["steps"] == 25
    with torch.no_grad():
        assert float(model.loss(held)) < before - 0.05


def test_grad_accum_equivalence():
    """microbatches=4 gives (numerically) the update of microbatches=1 on
    the same global batch."""
    _, _, _, s1, step1, dc = _setup(microbatches=1)
    _, _, _, s4, step4, _ = _setup(microbatches=4)
    batch = {k: torch.as_tensor(v)
             for k, v in SyntheticSource(dc).batch_at(0).items()}
    s1b, m1 = step1(s1, batch)
    s4b, m4 = step4(s4, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(_param0(s1b).numpy(), _param0(s4b).numpy(),
                               atol=1e-5)


def test_checkpoint_resume_bitexact(tmp_path):
    """Train 10 with checkpoints at 5 and 10; a fresh trainer resumes at
    10 with the same state; one resumed at 5 and run to 10 repeats the
    first run's losses and parameters bit for bit (CPU)."""
    cfg, model, opt, state, step, dc = _setup()
    tcfg = TrainerConfig(total_steps=10, checkpoint_every=5,
                         checkpoint_dir=str(tmp_path), log_every=100)
    tr = Trainer(step, state, Pipeline(SyntheticSource(dc)), tcfg)
    tr.run()
    want = {k: v.detach().clone() for k, v in tr.state.params.items()}

    _, _, _, state2, step2, _ = _setup(seed=1)
    tr2 = Trainer(step2, state2, Pipeline(SyntheticSource(dc)), tcfg)
    tr2.maybe_resume()
    assert int(tr2.state.step) == 10
    for k, v in tr2.state.params.items():
        assert torch.equal(v, want[k]), k
    for k in want:
        assert torch.equal(tr2.state.opt.mu[k], tr.state.opt.mu[k]), k

    shutil.rmtree(tmp_path / "step_000000010")
    (tmp_path / "LATEST").write_text("step_000000005")
    _, _, _, state3, step3, _ = _setup(seed=2)
    tr3 = Trainer(step3, state3, Pipeline(SyntheticSource(dc)),
                  dataclasses.replace(tcfg, checkpoint_every=100))
    tr3.maybe_resume()
    assert tr3.state.step == 5 and tr3.pipeline.step == 5
    tr3.run()
    assert tr3.history == tr.history[5:]
    for k, v in tr3.state.params.items():
        assert torch.equal(v, want[k]), k


def test_fault_retry_recovers():
    cfg, model, opt, state, step, dc = _setup()
    tr = Trainer(step, state, Pipeline(SyntheticSource(dc)),
                 TrainerConfig(total_steps=6, max_retries=2, log_every=100))
    boom = {"left": 2}

    def fault_hook(s):
        if s == 3 and boom["left"] > 0:
            boom["left"] -= 1
            raise RuntimeError("injected preemption")

    res = tr.run(fault_hook=fault_hook)
    assert res["steps"] == 6
    assert res["retries"] == 2


def test_fault_inside_the_step_leaves_the_state_untouched():
    """A failure inside the step (here in the model's backward pass, after
    the forward ran) is retried from the state as it was: the run equals
    one without the fault, bit for bit."""
    runs = []
    for inject in (False, True):
        cfg, model, opt, state, step, dc = _setup()
        left = {"n": 1 if inject else 0}
        loss_fn = model.loss

        def faulty_loss(*a, **kw):
            out = loss_fn(*a, **kw)
            if left["n"] and tr.state.step == 3:
                left["n"] -= 1
                out = out + _Boom.apply(out)  # adds 0; its backward raises
            return out
        model.loss = faulty_loss
        tr = Trainer(step, state, Pipeline(SyntheticSource(dc)),
                     TrainerConfig(total_steps=5, max_retries=1,
                                   log_every=100))
        res = tr.run()
        assert res["retries"] == int(inject)
        runs.append((tr.history, {k: v.detach().clone()
                                  for k, v in tr.state.params.items()}))
    assert runs[0][0] == runs[1][0]
    for k in runs[0][1]:
        assert torch.equal(runs[0][1][k], runs[1][1][k]), k


class _Boom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("injected fault in the backward pass")


def test_fault_exhausts_retries():
    cfg, model, opt, state, step, dc = _setup()
    tr = Trainer(step, state, Pipeline(SyntheticSource(dc)),
                 TrainerConfig(total_steps=4, max_retries=1, log_every=100))

    def always_fail(s):
        if s == 2:
            raise RuntimeError("hard failure")

    with pytest.raises(RuntimeError):
        tr.run(fault_hook=always_fail)


def test_straggler_detection():
    cfg, model, opt, state, step, dc = _setup()
    slow = {"at": 15}
    tr = Trainer(step, state, Pipeline(SyntheticSource(dc)),
                 TrainerConfig(total_steps=20, straggler_factor=3.0,
                               straggler_warmup=5, log_every=100))
    # wrap train_step to stall INSIDE the timed region
    orig = tr.train_step

    def slow_step(state, batch):
        if int(state.step) == slow["at"]:
            time.sleep(1.0)  # far above the EWMA of CPU smoke steps
        return orig(state, batch)

    tr.train_step = slow_step
    res = tr.run()
    assert res["stragglers"] >= 1


def test_moe_monitor_updates_hot_mask():
    """Expert-load counters accumulate and the adaptive hot mask refreshes
    between steps (the paper's off-critical-path recalibration)."""
    cfg, model, opt, state, step, dc = _setup(MOE, n_hot=2)
    batch = {k: torch.as_tensor(v)
             for k, v in SyntheticSource(dc).batch_at(0).items()}
    assert state.expert_counts is not None
    s1, _ = step(state, batch)
    assert int(s1.expert_counts.sum()) == \
        SEQ * BATCH * cfg.top_k * cfg.n_layers
    assert int(s1.hot_mask.sum()) == 2  # top-2 experts hot
    s2, _ = step(s1, batch)
    assert int(s2.expert_counts.sum()) > int(s1.expert_counts.sum())


def test_warmup_cosine_schedule():
    sched = warmup_cosine(1e-3, 10, 100, floor=0.1)
    assert float(sched(torch.tensor(0))) == 0.0
    assert abs(float(sched(torch.tensor(10))) - 1e-3) < 1e-9
    assert float(sched(torch.tensor(100))) == pytest.approx(1e-4, rel=1e-3)
    assert float(sched(torch.tensor(55))) < 1e-3
    jsched = jwarmup(1e-3, 10, 100, floor=0.1)
    for s in (0, 3, 10, 37, 55, 99, 100, 140):
        assert float(sched(torch.tensor(s))) == float(jsched(jnp.asarray(s)))


# ---------------------------------------------------------------------------
# serving after training
# ---------------------------------------------------------------------------


def test_serving_after_training_reads_the_new_weights():
    """The stale-copy trap: a bf16 model serves once (its cached bf16
    copies made), trains two steps, and serves again; its logits equal a
    model loaded fresh from the trained fp32 masters."""
    cfg = dataclasses.replace(get_config(DENSE).reduced(), dtype="bfloat16")
    model = build_model(cfg, device="cpu").init(0)
    prompt = torch.as_tensor(_batch(cfg.vocab)["tokens"][:2, :12])
    before, _ = model.prefill(prompt, 16)
    opt = AdamW(lr=1e-2)
    state = init_train_state(model, opt, None)
    step = make_train_step(model, opt)
    for i in range(2):
        state, _ = step(state, {k: torch.as_tensor(v)
                                for k, v in _batch(cfg.vocab, i).items()})
    after, _ = model.prefill(prompt, 16)
    fresh = params_from_numpy(jax_tree(model.named_parameters(), numpy_leaf),
                              build_model(cfg, device="cpu"))
    want, _ = fresh.prefill(prompt, 16)
    assert not torch.equal(after, before)
    assert torch.equal(after, want)
