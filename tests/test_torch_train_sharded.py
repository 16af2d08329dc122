"""The sharded train step of the port against its unsharded step and the JAX
package's, on the CPU (``REPRO_TORCH_VIRTUAL_DEVICES``: a mesh of virtual
CPU devices), fp32.

Reduced stablelm-1.6b and granite-moe-3b-a800m (staged, direct and
adaptive dispatch), the JAX package's weights (``params_from_numpy``), two
steps of ``SyntheticSource`` batches of 8 x 32 tokens in 2 microbatches,
remat, AdamW under warmup-cosine (lr 1e-2), on three meshes:

* ``(data 2, model 2)``: stablelm's scheme ``heads``, granite's
  ``qheads_kvrepl`` (4 q heads over 1 kv head), the vocab and the experts
  split natively, FSDP over ``data``;
* ``(data 1, model 3)``: scheme ``replicate``, the 4 heads padded to 6,
  the vocab 256 to 258, the 8 experts to 9;
* ``(pod 2, data 1, model 2)``: the rows split over ``(pod, data)``.

Held, every step, against the port's unsharded step and JAX's
``make_train_step``: the loss within 1e-5 relative, the grad norm within
1e-4 relative, lr exactly, the expert counts and the hot mask exactly. The
first step's gradients, leaf by leaf, within 1e-5 of the leaf's largest
entry plus 1e-5 relative of the unsharded port's (two fp32 CPU backward
passes that sum in other orders; measured: about 1e-6), and JAX's through
its first moment (``mu = (1 - b1) * clip_scale * g``), within the same.
The new masters and both moments after the two steps: every entry within
``2 * lr * steps`` (Adam's step is at most about lr per entry), and at most
0.1 % of a leaf's entries past 1e-5 among those whose gradient is, on every
step, above 1e-4 of its leaf's largest (Adam divides each entry by its own
RMS, so the fp32 noise of an entry whose gradient is near zero becomes a
visible part of a step: the rule ``chip_smoke.py``'s ``parity_train`` uses).

Also: each state leaf's pieces have the shapes its spec gives and no whole
master is left on a device (the model's are ``meta`` tensors); the padded
heads, vocab lanes and experts get exactly zero gradient; on ``(2, 2)``
stablelm's step gathers no parameter over ``model`` (the collectives'
counters: the only ``model``-axis gather is the residual stream's D after
the lookup on the D-split ``tok``); K3, its backward and the staged drain
run once per device for each unsharded call, as ``models.remat_calls``
counts; the collectives' bytes equal those the specs give
(``expected_collective_bytes``), also on the ``headdim``, tied-head and
padded-expert paths; two sharded steps from one seed are bit-equal; a sharded state's
checkpoint equals the unsharded one's leaf for leaf, restores onto a mesh,
and ``repro.checkpoint`` reads it.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.optim import AdamW as JAdamW
from repro.optim import warmup_cosine as jwarmup
from repro.train import init_train_state as jinit
from repro.train import make_train_step as jmake
from repro_torch import checkpoint as ckpt
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticSource
from repro_torch.distributed import (VIRTUAL_DEVICES_ENV, ParallelConfig,
                                     ShardedTensor)
from repro_torch.distributed import collectives as C
from repro_torch.kernels import FlashAttentionFunction
from repro_torch.models import build_model, remat_calls
from repro_torch.models import parallel as PL
from repro_torch.models.layout import jax_tree, numpy_leaf
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.train import init_train_state, make_train_step

torch.set_num_threads(1)

DENSE, MOE = "stablelm-1.6b", "granite-moe-3b-a800m"
SEQ, BATCH, MB, STEPS, LR = 32, 8, 2, 2, 1e-2
N_HOT = 2
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x3": ((1, 3), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
CONFIGS = [(DENSE, None), (MOE, "staged"), (MOE, "direct"),
           (MOE, "adaptive")]
GRAD_RTOL = 1e-5        # a gradient leaf: this share of its largest entry
PINNED = 1e-4           # an entry's gradient above this share of the max


@pytest.fixture(autouse=True)
def _virtual(monkeypatch):
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "4")


def _batches(vocab):
    src = SyntheticSource(DataConfig(SEQ, BATCH, vocab))
    return [src.batch_at(i) for i in range(STEPS)]


class _Kept:
    """An optimizer that keeps a host copy of each update's gradients
    (whole leaves), before the clip scales them."""

    def __init__(self, opt):
        self.opt, self.kept = opt, []

    def __getattr__(self, name):
        return getattr(self.opt, name)

    def update(self, grads, state, params):
        self.kept.append({
            k: (g.gather("cpu") if isinstance(g, ShardedTensor)
                else g).detach().clone() for k, g in grads.items()})
        return self.opt.update(grads, state, params)


def _whole(x):
    return (x.gather("cpu") if isinstance(x, ShardedTensor) else x).detach()


@functools.lru_cache(maxsize=None)
def _jax_run(arch, mode):
    """JAX's unsharded steps: per step (loss, grad_norm, lr, counts, hot),
    the first step's mu and nu, the final params / mu / nu (numpy trees),
    and the initial params."""
    kw = {"dispatch_mode": mode} if mode else {}
    n_hot = N_HOT if mode else 0
    jm = jbuild(jget(arch).reduced(), **kw)
    opt = JAdamW(lr=jwarmup(LR, 1, 3))
    st = jinit(jm, opt, jax.random.key(3), SEQ, n_hot_experts=n_hot)
    init = jax.tree.map(np.asarray, st.params)
    step = jax.jit(jmake(jm, opt, microbatches=MB, n_hot_experts=n_hot))
    mets, first = [], None
    for b in _batches(jm.cfg.vocab):
        st, m = step(st, {k: jnp.asarray(v) for k, v in b.items()})
        mets.append(dict(loss=float(m["loss"]),
                         grad_norm=float(m["grad_norm"]), lr=float(m["lr"]),
                         counts=None if st.expert_counts is None
                         else np.asarray(st.expert_counts),
                         hot=None if st.hot_mask is None
                         else np.asarray(st.hot_mask)))
        if first is None:
            first = jax.tree.map(np.asarray, (st.opt.mu, st.opt.nu))
    final = jax.tree.map(np.asarray, (st.params, st.opt.mu, st.opt.nu))
    return init, mets, first, final


def _port_run(arch, mode, mesh=None):
    """The port's steps from JAX's initial weights, on one device or on
    ``mesh`` (``(shape, axes)``): per step metrics and kept gradients, the
    first step's moments and the final state, all whole on the host."""
    kw = {"dispatch_mode": mode} if mode else {}
    n_hot = N_HOT if mode else 0
    init = _jax_run(arch, mode)[0]
    model = params_from_numpy(init, build_model(get_config(arch).reduced(),
                                                device="cpu", **kw))
    opt = _Kept(AdamW(lr=warmup_cosine(LR, 1, 3)))
    par = None if mesh is None else ParallelConfig(*mesh)
    st = init_train_state(model, opt, None, n_hot, parallel=par)
    step = make_train_step(model, opt, microbatches=MB, n_hot_experts=n_hot,
                           mesh=st.mesh)
    mets, first = [], None
    for b in _batches(model.cfg.vocab):
        st, m = step(st, {k: torch.as_tensor(v) for k, v in b.items()})
        mets.append(dict(loss=float(m["loss"]),
                         grad_norm=float(m["grad_norm"]), lr=float(m["lr"]),
                         counts=None if st.expert_counts is None
                         else st.expert_counts.numpy(),
                         hot=None if st.hot_mask is None
                         else st.hot_mask.numpy()))
        if first is None:
            first = ({k: _whole(v) for k, v in st.opt.mu.items()},
                     {k: _whole(v) for k, v in st.opt.nu.items()})
    final = ({k: _whole(v) for k, v in st.params.items()},
             {k: _whole(v) for k, v in st.opt.mu.items()},
             {k: _whole(v) for k, v in st.opt.nu.items()})
    return dict(mets=mets, grads=opt.kept, first=first, final=final,
                state=st)


_unsharded = functools.lru_cache(maxsize=None)(
    lambda arch, mode: _port_run(arch, mode))


def _as_jax(named):
    """A name -> tensor map in the JAX layout, keyed like JAX's leaves."""
    tree = jax_tree(named.items(), numpy_leaf)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def _close_grads(got, want, what):
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (what, k)
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(w).max(),
                                   err_msg=f"{what} {k}")


def _close_state(got, want, pinned, what):
    """The rule for the masters and moments after the steps (see the
    module's docstring)."""
    for k, w in want.items():
        d = np.abs(got[k] - w).reshape(-1)
        assert d.max() <= 2 * LR * STEPS, (what, k, d.max())
        held = d[pinned[k].reshape(-1)] > 1e-5
        assert held.sum() <= 1e-3 * d.size, (what, k, int(held.sum()))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,mode", CONFIGS)
def test_sharded_step_equals_unsharded_and_jax(arch, mode, mesh):
    jinit_, jmets, jfirst, jfinal = _jax_run(arch, mode)
    ref = _unsharded(arch, mode)
    got = _port_run(arch, mode, MESHES[mesh])
    for i, (g, r, j) in enumerate(zip(got["mets"], ref["mets"], jmets)):
        for want in (r, j):
            assert g["loss"] == pytest.approx(want["loss"], rel=1e-5), i
            assert g["grad_norm"] == pytest.approx(want["grad_norm"],
                                                   rel=1e-4), i
            assert g["lr"] == want["lr"], i
            if mode:
                assert np.array_equal(g["counts"], want["counts"]), i
                assert np.array_equal(g["hot"], want["hot"]), i
    # the first step's gradients: the port's unsharded, and JAX's through
    # its first moment
    tg = {k: v.numpy() for k, v in got["grads"][0].items()}
    _close_grads(tg, {k: v.numpy() for k, v in ref["grads"][0].items()},
                 "grad")
    _close_grads(_as_jax({k: v for k, v in got["first"][0].items()}),
                 _as_jax_tree(jfirst[0]), "mu vs jax")
    # the masters and moments after the steps
    pinned = {k: np.all([np.abs(s[k].numpy()) > PINNED
                         * np.abs(s[k].numpy()).max()
                         for s in ref["grads"]], axis=0)
              for k in ref["grads"][0]}
    for name, a, b in zip(("params", "mu", "nu"), got["final"],
                          ref["final"]):
        _close_state({k: v.numpy() for k, v in a.items()},
                     {k: v.numpy() for k, v in b.items()}, pinned, name)
    jp = dict(zip(("params", "mu", "nu"), jfinal))
    jpinned = _as_jax({k: torch.from_numpy(v) for k, v in pinned.items()})
    for name, a in zip(("params", "mu", "nu"), got["final"]):
        _close_state(_as_jax(a), _as_jax_tree(jp[name]), jpinned,
                     f"{name} vs jax")


def _as_jax_tree(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


# ---------------------------------------------------------------------------
# placement, padding, collectives, launches, determinism, checkpoints
# ---------------------------------------------------------------------------


def _placed(arch, mode, mesh, seed=0):
    kw = {"dispatch_mode": mode} if mode else {}
    model = build_model(get_config(arch).reduced(), device="cpu", **kw)
    opt = AdamW(lr=warmup_cosine(LR, 1, 3))
    st = init_train_state(model, opt, seed, N_HOT if mode else 0,
                          parallel=ParallelConfig(*MESHES[mesh]))
    step = make_train_step(model, opt, microbatches=MB,
                           n_hot_experts=N_HOT if mode else 0, mesh=st.mesh)
    return model, st, step


@pytest.mark.parametrize("arch,mode,mesh", [(DENSE, None, "2x2"),
                                            (MOE, "staged", "1x3")])
def test_pieces_have_their_specs_shapes(arch, mode, mesh):
    model, st, _ = _placed(arch, mode, mesh)
    plan = PL.MeshPlan(model, st.mesh)
    assert all(p.device.type == "meta" for p in model.parameters())
    for tree in (st.shards, st.opt.mu, st.opt.nu):
        for k, v in tree.items():
            assert v.sharding.spec == plan.specs[k], k
            want = list(v.shape)
            for ax, axes in v.splits:
                n = 1
                for a in axes:
                    n *= st.mesh.shape[a]
                want[ax] //= n
            assert all(list(p.shape) == want for p in v.shards), k
    # a split leaf is never whole on a device
    wq = st.shards["blocks.0.attn.wq"]
    assert wq.sharding.spec != (None, None, None) or mesh == "1x3"


def test_padded_heads_lanes_and_experts_get_zero_gradient(monkeypatch):
    """On (1, 3) the 4 heads run as 6, the vocab as 258 lanes and the 8
    experts as 9: the padded rows of every padded tensor get exactly zero
    gradient, and none of them is kept."""
    from repro_torch.models import layers as L
    padded = []
    real_pad = L.pad_axis

    def pad(x, dim, n):
        out = real_pad(x, dim, n)
        if out is not x and out.requires_grad:
            out.retain_grad()
            padded.append((out, dim, x.shape[dim]))
        return out
    monkeypatch.setattr(L, "pad_axis", pad)
    model, st, _ = _placed(MOE, "staged", "1x3")
    plan = PL.MeshPlan(model, st.mesh)
    assert (plan.hp, plan.vp, plan.ep) == (6, 258, 9)
    params = {k: list(v.shards) for k, v in st.shards.items()}
    b = {k: torch.as_tensor(v) for k, v in _batches(256)[0].items()}
    losses, _, _ = PL.sharded_loss(plan, params, b, remat=False)
    torch.autograd.grad(losses, [p for ps in params.values() for p in ps])
    kinds = set()
    for out, dim, n in padded:
        if out.grad is None:
            continue
        kinds.add((tuple(out.shape), dim))
        extra = out.grad.narrow(dim, n, out.shape[dim] - n)
        assert extra.abs().max() == 0, (tuple(out.shape), dim)
    # heads (wq, wo), kv zero heads, vocab rows and expert rows were padded
    assert any(s[d] == 6 for s, d in kinds) and any(s[d] == 258
                                                    for s, d in kinds)
    assert any(s[d] == 9 for s, d in kinds)
    for k, v in st.shards.items():
        assert v.shape == dict(model.named_parameters())[k].shape, k


def test_megatron_paths_gather_no_parameter_over_model():
    """(2, 2) stablelm (scheme ``heads``, ff and vocab split natively): by
    the counters, the only ``model``-axis gather of a step is the residual
    stream's D after the lookup, forward and under remat; parameters are
    gathered over ``data`` (FSDP, reduce-scattered back) and the replicated
    leaves' gradients summed over ``data``."""
    _, st, step = _placed(DENSE, None, "2x2")
    C.reset_collective_counts()
    step(st, {k: torch.as_tensor(v) for k, v in _batches(256)[0].items()})
    counts = C.collective_counts()
    model_gathers = {c["what"] for c in counts
                     if c["op"] == "all_gather" and "model" in c["axes"]}
    assert model_gathers == {"embed"}
    ops = {(c["op"], tuple(c["axes"])) for c in counts}
    assert ("all_gather", ("data",)) in ops and \
        ("reduce_scatter", ("data",)) in ops
    assert ("all_reduce", ("model",)) in ops
    fsdp = {c["what"] for c in counts if c["op"] == "all_gather"
            and c["axes"] == ["data"]}
    assert "blocks/attn/wq" in fsdp and "blocks/mlp/wi" in fsdp
    bytes_ = C.collective_bytes()
    assert bytes_["all_gather:data"] > 0 and bytes_["all_reduce:data"] > 0


@pytest.mark.parametrize("arch,over,mode,shape", [
    (DENSE, {}, None, (2, 2)),
    (DENSE, {}, None, (1, 3)),
    (MOE, {}, "staged", (2, 1, 2)),
    # head_dim split (6 heads over 4), kv heads over it, FSDP
    (DENSE, dict(n_heads=6, n_kv_heads=3, qkv_bias=True), None, (2, 4)),
    # tied head over an indivisible D and vocab
    (DENSE, dict(tie_embeddings=True, d_model=66), None, (1, 3)),
    # 6 experts over 4: padded to 8, their ff split over model
    (MOE, dict(n_experts=6), "adaptive", (2, 4))])
def test_collective_bytes_equal_the_specs(arch, over, mode, shape,
                                          monkeypatch):
    """A step's collectives move, op by op and axis by axis, the bytes
    ``expected_collective_bytes`` works out from the specs and shapes
    alone; and the step equals the unsharded one (loss within 1e-5, grad
    norm within 1e-4 relative) on the scheme and padding paths the three
    parity meshes do not reach (``headdim``, a tied head, experts padded
    with their ff split over ``model``)."""
    import dataclasses
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "8")
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    kw = {"dispatch_mode": mode} if mode else {}
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    b = {k: torch.as_tensor(v) for k, v in _batches(cfg.vocab)[0].items()}
    out = []
    for par in (None, ParallelConfig(shape, axes)):
        model = build_model(cfg, device="cpu", **kw)
        opt = AdamW(lr=warmup_cosine(LR, 1, 3))
        st = init_train_state(model, opt, 3, N_HOT if mode else 0,
                              parallel=par)
        step = make_train_step(model, opt, microbatches=MB, mesh=st.mesh,
                               n_hot_experts=N_HOT if mode else 0)
        C.reset_collective_counts()
        st, m = step(st, b)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    assert C.collective_bytes() == PL.expected_collective_bytes(
        PL.MeshPlan(model, st.mesh), BATCH // MB, SEQ, MB)
    assert out[1][0] == pytest.approx(out[0][0], rel=1e-5)
    assert out[1][1] == pytest.approx(out[0][1], rel=1e-4)


@pytest.mark.parametrize("arch,mode,mesh", [(DENSE, None, "2x2"),
                                            (MOE, "staged", "2x1x2")])
def test_kernel_calls_per_device_under_remat(arch, mode, mesh, monkeypatch):
    """K3 forward and backward (``FlashAttentionFunction``) and the staged
    drain run once per device for each unsharded call: ``remat_calls`` x
    microbatches x devices; the drain twice a layer (its recompute) and
    its adjoint once."""
    import importlib
    KS = importlib.import_module("repro_torch.kernels.staged_scatter")
    seen = dict.fromkeys(("flash_attention", "flash_attention_bwd",
                          "staged_drain", "staged_gather"), 0)

    def counted(name, fn):
        def run(*a, **kw):
            seen[name] += 1
            return fn(*a, **kw)
        return run
    monkeypatch.setattr(FlashAttentionFunction, "forward", staticmethod(
        counted("flash_attention", FlashAttentionFunction.forward)))
    monkeypatch.setattr(FlashAttentionFunction, "backward", staticmethod(
        counted("flash_attention_bwd", FlashAttentionFunction.backward)))
    monkeypatch.setattr(KS, "_drain", counted("staged_drain", KS._drain))
    monkeypatch.setattr(KS, "staged_gather", counted("staged_gather",
                                                     KS.staged_gather))
    model, st, step = _placed(arch, mode, mesh)
    step(st, {k: torch.as_tensor(v) for k, v in _batches(256)[0].items()})
    n = MB * len(st.mesh.devices)
    calls = remat_calls(model.cfg)
    want = {k: calls[k] * n for k in ("flash_attention",
                                      "flash_attention_bwd")}
    layers = model.cfg.n_layers
    want.update(staged_drain=2 * layers * n if mode else 0,
                staged_gather=layers * n if mode else 0)
    assert seen == want


def test_sharded_steps_repeat_bit_for_bit():
    out = []
    for _ in range(2):
        _, st, step = _placed(MOE, "adaptive", "2x2")
        for b in _batches(256):
            st, m = step(st, {k: torch.as_tensor(v) for k, v in b.items()})
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    {k: _whole(v) for k, v in st.shards.items()}))
    assert out[0][:2] == out[1][:2]
    assert all(torch.equal(v, out[1][2][k]) for k, v in out[0][2].items())


def _files(root):
    """Every leaf of a checkpoint step, by its key."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, key)
            else:
                out[key] = v
    walk(ckpt.load_checkpoint(root), "")
    return out


def test_sharded_checkpoint_equals_unsharded_and_restores(tmp_path):
    """A state placed on (2, 2) writes the JAX layout's whole leaves, file
    for file those of the same state unplaced; after a step it restores
    onto a mesh (each leaf placed by the rules, every piece equal) and the
    JAX package's ``restore`` reads it."""
    from repro_torch.train import place_train_state
    model = build_model(get_config(MOE).reduced(), device="cpu",
                        dispatch_mode="adaptive")
    opt = AdamW(lr=warmup_cosine(LR, 1, 3))
    st = init_train_state(model, opt, 0, N_HOT)
    ckpt.save(str(tmp_path / "a"), 0, st)
    mesh = ParallelConfig(*MESHES["2x2"]).build_mesh(device="cpu")
    placed = place_train_state(st, mesh)
    ckpt.save(str(tmp_path / "b"), 0, placed)
    fa, fb = _files(str(tmp_path / "a")), _files(str(tmp_path / "b"))
    assert fa.keys() == fb.keys() and len(fa) > 20
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k]), k
    step = make_train_step(model, opt, microbatches=MB, n_hot_experts=N_HOT,
                           mesh=mesh)
    placed, _ = step(placed, {k: torch.as_tensor(v)
                              for k, v in _batches(256)[0].items()})
    ckpt.save(str(tmp_path / "c"), 1, placed)
    _, fresh, _ = _placed(MOE, "adaptive", "2x2", seed=5)
    back = ckpt.restore(str(tmp_path / "c"), fresh)
    assert back.step == 1 and back.mesh is fresh.mesh
    for tree, want in ((back.shards, placed.shards),
                       (back.opt.mu, placed.opt.mu),
                       (back.opt.nu, placed.opt.nu)):
        for k, v in tree.items():
            assert v.sharding.spec == want[k].sharding.spec, k
            assert all(torch.equal(x, y) for x, y in
                       zip(v.shards, want[k].shards)), k
    assert torch.equal(back.expert_counts, placed.expert_counts)
    assert torch.equal(back.hot_mask, placed.hot_mask)
    jm = jbuild(jget(MOE).reduced(), dispatch_mode="adaptive")
    tmpl = jinit(jm, JAdamW(), jax.random.key(0), SEQ, n_hot_experts=N_HOT)
    js = jckpt.restore(str(tmp_path / "c"), tmpl)
    assert int(js.step) == 1
    np.testing.assert_array_equal(np.asarray(js.expert_counts),
                                  placed.expert_counts.numpy())
    want = _as_jax(placed.params)
    for k, v in _as_jax_tree(js.params).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    # and a step the JAX package wrote restores onto the mesh
    jckpt.save(str(tmp_path / "j"), 3, tmpl)
    _, fresh, _ = _placed(MOE, "adaptive", "2x2", seed=6)
    back = ckpt.restore(str(tmp_path / "j"), fresh)
    assert back.step == 0 and back.shards["embed.tok"].sharding.spec == \
        fresh.shards["embed.tok"].sharding.spec
    want = _as_jax_tree(tmpl.params)
    for k, v in _as_jax(back.params).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_a_failed_sharded_step_leaves_every_piece(monkeypatch):
    """The commit is the last thing a step does: a step that fails in its
    second microbatch leaves every piece, moment and counter as it was."""
    _, st, step = _placed(MOE, "adaptive", "2x2")
    before = {k: [p.detach().clone() for p in v.shards]
              for k, v in st.shards.items()}
    mu = {k: [p.clone() for p in v.shards] for k, v in st.opt.mu.items()}
    counts = st.expert_counts.clone()
    real, calls = PL.sharded_loss, []

    def failing(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected fault")
        return real(*a, **kw)
    monkeypatch.setattr(PL, "sharded_loss", failing)
    with pytest.raises(RuntimeError, match="injected"):
        step(st, {k: torch.as_tensor(v) for k, v in _batches(256)[0].items()})
    for k, v in st.shards.items():
        assert all(torch.equal(p, q) for p, q in zip(v.shards, before[k])), k
    for k, v in st.opt.mu.items():
        assert all(torch.equal(p, q) for p, q in zip(v.shards, mu[k])), k
    assert torch.equal(st.expert_counts, counts) and st.step == 0
