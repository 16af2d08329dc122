"""The sharded train step of the SSM, hybrid, encoder-decoder and VLM
families against the port's unsharded step and the JAX package's, on the CPU
(``REPRO_TORCH_VIRTUAL_DEVICES``: a mesh of virtual CPU devices), fp32.

Reduced mamba2-130m (its head tied to the embedding), zamba2-2.7b (two
applications of the shared block), whisper-medium (frames ``[32, 64]``)
and llama-3.2-vision-90b at 4 layers (two groups, 16 image tokens, its
gates drawn from a seed on both sides: at zero they would zero every cross
gradient); the JAX package's weights (``params_from_numpy``); two steps of
``SyntheticSource`` batches of 8 x 40 tokens (not a multiple of the SSD's
chunk of 16) in 2 microbatches, remat, AdamW under warmup-cosine (lr
1e-2), on the meshes of ``tests/test_torch_train_sharded.py``:

* ``(data 2, model 2)``: zamba2's and whisper's scheme ``heads``, the
  VLM's ``qheads_kvrepl`` (4 q heads over 1 kv head), FSDP over ``data``;
* ``(data 1, model 3)``: scheme ``replicate``, the 4 heads padded to 6,
  the vocab 256 to 258 lanes;
* ``(pod 2, data 1, model 2)``: the rows (and media) split over ``(pod,
  data)``.

Held, every step, against the port's unsharded step and JAX's
``make_train_step`` with the tolerances of the dense and MoE file: the
loss within 1e-5 relative, the grad norm within 1e-4, lr exactly; the first
step's gradients leaf by leaf within 1e-5 of the leaf's largest entry
(JAX's through its first moment); the masters and both moments after the
two steps within ``2 * lr * steps``; after the first step, also at most
0.1 % of a leaf's entries past 1e-5 among those whose gradient is above
1e-4 of its leaf's largest. (Adam's first step moves an entry whose
gradient is fp32 noise by up to lr either way, so the second step's
gradients part a little everywhere: on mamba2 over ``(1, 3)`` nine of
``out_proj``'s 8192 entries then part by more than 1e-5 though their
gradients are well above the noise.)

Also, from the same runs: every leaf the rules leave whole (the mamba
leaves but ``in_proj`` / ``out_proj``, the norms, ``enc_pos`` /
``dec_pos``, the VLM's gates) gets the unsharded gradient on every rank
(summed over ``model`` it would be m times that); K3, its backward and
the SSD run once per device for each unsharded call (``remat_calls``);
each collective's bytes equal ``expected_collective_bytes``. And: the
pieces have their specs' shapes; padded heads and vocab lanes get exactly
zero gradient; the ``headdim`` scheme, a D that ``model`` does not divide,
the VLM without media and remat off give the unsharded loss and the
specs' bytes; two sharded steps repeat bit for bit; a sharded checkpoint
equals the unsharded one, restores onto a mesh, and ``repro.checkpoint``
reads it; ``launch.train`` takes the mesh branch for every family
(whisper without media refused there as on one device).
"""
import dataclasses
import functools
from unittest import mock

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
from repro.train import TrainState as JTrainState
from repro.train import make_train_step as jmake
from repro_torch import checkpoint as ckpt
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticSource
from repro_torch.distributed import (VIRTUAL_DEVICES_ENV, ParallelConfig,
                                     ShardedTensor)
from repro_torch.distributed import collectives as C
from repro_torch.kernels import FlashAttentionFunction
from repro_torch.models import build_model, media_spec, needs_media
from repro_torch.models import mamba2 as TM
from repro_torch.models import parallel as PL
from repro_torch.models import remat_calls
from repro_torch.models.layout import jax_tree, numpy_leaf
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.train import (init_train_state, make_train_step,
                               place_train_state)

torch.set_num_threads(1)

ARCHS = {"ssm": "mamba2-130m", "hybrid": "zamba2-2.7b",
         "encdec": "whisper-medium", "vlm": "llama-3.2-vision-90b"}
FAMILIES = list(ARCHS)
SEQ, BATCH, MB, STEPS, LR = 40, 8, 2, 2, 1e-2
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x3": ((1, 3), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
CASES = [(f, m) for f in FAMILIES for m in sorted(MESHES)]
GRAD_RTOL = 1e-5        # a gradient leaf: this share of its largest entry
PINNED = 1e-4           # an entry's gradient above this share of the max
KERNELS = ("flash_attention", "flash_attention_bwd", "ssd_chunked")


@pytest.fixture(autouse=True)
def _virtual(monkeypatch):
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "4")


def family_cfg(fam, get, **over):
    """The reduced config of ``fam`` from ``get`` (either package's
    ``get_config``); the VLM at 4 layers, two groups."""
    cfg = get(ARCHS[fam]).reduced()
    if fam == "vlm":
        over = dict(dict(n_layers=4), **over)
    return dataclasses.replace(cfg, **over)


def _batch(cfg, step, media=True):
    """numpy tokens / labels at ``step`` and, for a family that reads them,
    media from a seeded ``RandomState``."""
    batch = SyntheticSource(DataConfig(SEQ, BATCH, cfg.vocab)).batch_at(step)
    if media and needs_media(cfg):
        rng = np.random.RandomState(100 + step)
        batch["media"] = rng.randn(*media_spec(cfg, BATCH)).astype(np.float32)
    return batch


def _tb(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


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


def _whole(x):
    """A copy of ``x`` whole on the host (the masters change in place)."""
    return (x.gather("cpu") if isinstance(x, ShardedTensor)
            else x).detach().clone()


def _as_jax(named):
    """A name -> tensor (or numpy array) map in the JAX layout, keyed like
    JAX's leaves."""
    return _as_jax_tree(jax_tree(named.items(), numpy_leaf))


def _as_jax_tree(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


class _Kept:
    """An optimizer that keeps a host copy of each update's gradients
    (whole leaves) and, of the first, each device's piece."""

    def __init__(self, opt):
        self.opt, self.kept, self.pieces = opt, [], None

    def __getattr__(self, name):
        return getattr(self.opt, name)

    def update(self, grads, state, params):
        self.kept.append({k: _whole(g) for k, g in grads.items()})
        if self.pieces is None:
            self.pieces = {k: [p.detach().clone() for p in g.shards]
                           for k, g in grads.items()
                           if isinstance(g, ShardedTensor)}
        return self.opt.update(grads, state, params)


# the JAX programs of this file are compiled without the backend's
# optimisations: each runs once or twice, and compiling is most of its time
FAST = {"xla_backend_optimization_level": 0}


def _jax_state(jm, opt, seed):
    """JAX's ``init_train_state`` of ``jm`` from ``jax.random.key(seed)``,
    its init run as one compiled program (eagerly it dispatches op by
    op)."""
    key = jax.random.key(seed)
    params = jax.jit(lambda k: jm.init(k, SEQ)).lower(key).compile(
        compiler_options=FAST)(key)
    return JTrainState(params, opt.init(params), jnp.zeros((), jnp.int32),
                       None, None)


@functools.lru_cache(maxsize=None)
def _jax_run(fam):
    """JAX's unsharded steps, made once a family (its jitted step):
    per step (loss, grad_norm, lr), the params / mu / nu after each step
    (numpy trees), and the initial params (gates seeded)."""
    jm = jbuild(family_cfg(fam, jget))
    opt = JAdamW(lr=jwarmup(LR, 1, 3))
    st = _jax_state(jm, opt, 3)
    st = st._replace(params=seeded_gates(st.params))
    init = jax.tree.map(np.asarray, st.params)
    batches = [{k: jnp.asarray(v) for k, v in _batch(jm.cfg, i).items()}
               for i in range(STEPS)]
    step = jax.jit(jmake(jm, opt, microbatches=MB)).lower(
        st, batches[0]).compile(compiler_options=FAST)
    mets, states = [], []
    for b in batches:
        st, m = step(st, b)
        mets.append(dict(loss=float(m["loss"]),
                         grad_norm=float(m["grad_norm"]), lr=float(m["lr"])))
        states.append(jax.tree.map(np.asarray,
                                   (st.params, st.opt.mu, st.opt.nu)))
    return init, mets, states


def _counting():
    """Patches that count K3's forward / backward and the SSD's calls into
    ``seen``."""
    seen = dict.fromkeys(KERNELS, 0)

    def counted(name, fn):
        def run(*a, **kw):
            seen[name] += 1
            return fn(*a, **kw)
        return run
    patches = [
        mock.patch.object(FlashAttentionFunction, "forward", staticmethod(
            counted("flash_attention", FlashAttentionFunction.forward))),
        mock.patch.object(FlashAttentionFunction, "backward", staticmethod(
            counted("flash_attention_bwd",
                    FlashAttentionFunction.backward))),
        mock.patch.object(TM, "ssd_chunked",
                          counted("ssd_chunked", TM.ssd_chunked))]
    return seen, patches


@functools.lru_cache(maxsize=None)
def _port_run(fam, mesh=None):
    """The port's steps from JAX's initial weights, on one device or on
    ``MESHES[mesh]``, made once: per step metrics, kept gradients and the
    params / mu / nu after it (whole on the host), the first step's pieces
    of each gradient, its collective bytes and kernel calls, the state and
    the plan."""
    init = _jax_run(fam)[0]
    model = params_from_numpy(init, build_model(
        family_cfg(fam, get_config), device="cpu", max_seq=SEQ))
    opt = _Kept(AdamW(lr=warmup_cosine(LR, 1, 3)))
    par = None if mesh is None else ParallelConfig(*MESHES[mesh])
    st = init_train_state(model, opt, None, parallel=par)
    step = make_train_step(model, opt, microbatches=MB, mesh=st.mesh)
    mets, states, moved, calls = [], [], None, None
    for i in range(STEPS):
        seen, patches = _counting()
        C.reset_collective_counts()
        for p in patches:
            p.start()
        try:
            st, m = step(st, _tb(_batch(model.cfg, i)))
        finally:
            for p in patches:
                p.stop()
        mets.append(dict(loss=float(m["loss"]),
                         grad_norm=float(m["grad_norm"]), lr=float(m["lr"])))
        if moved is None:
            moved, calls = C.collective_bytes(), seen
        states.append(tuple({k: _whole(v).numpy() for k, v in t.items()}
                            for t in (st.params, st.opt.mu, st.opt.nu)))
    return dict(mets=mets, grads=opt.kept, pieces=opt.pieces, states=states,
                state=st, bytes=moved, calls=calls,
                plan=None if st.mesh is None else PL.MeshPlan(model, st.mesh))


def _close_grads(got, want, what):
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (what, k)
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(w).max(),
                                   err_msg=f"{what} {k}")


def _close_state(got, want, pinned, what):
    """The rule for the masters and moments after the steps: every entry
    within ``2 * lr * steps``; with ``pinned`` (after the first step), at
    most 0.1 % of the pinned entries past 1e-5."""
    for k, w in want.items():
        d = np.abs(got[k] - w).reshape(-1)
        assert d.max() <= 2 * LR * STEPS, (what, k, d.max())
        if pinned is not None:
            held = d[pinned[k].reshape(-1)] > 1e-5
            assert held.sum() <= 1e-3 * d.size, (what, k, int(held.sum()))


@pytest.mark.parametrize("fam,mesh", CASES)
def test_sharded_step_equals_unsharded_and_jax(fam, mesh):
    _, jmets, jstates = _jax_run(fam)
    ref = _port_run(fam)
    got = _port_run(fam, mesh)
    for i, (g, r, j) in enumerate(zip(got["mets"], ref["mets"], jmets)):
        for want in (r, j):
            assert g["loss"] == pytest.approx(want["loss"], rel=1e-5), i
            assert g["grad_norm"] == pytest.approx(want["grad_norm"],
                                                   rel=1e-4), i
            assert g["lr"] == want["lr"], i
    # the first step's gradients: the port's unsharded, and JAX's through
    # its first moment
    _close_grads({k: v.numpy() for k, v in got["grads"][0].items()},
                 {k: v.numpy() for k, v in ref["grads"][0].items()}, "grad")
    _close_grads(_as_jax(got["states"][0][1]),
                 _as_jax_tree(jstates[0][1]), "mu vs jax")
    g0 = ref["grads"][0]
    pinned = {k: np.abs(v.numpy()) > PINNED * np.abs(v.numpy()).max()
              for k, v in g0.items()}
    jpinned = _as_jax(pinned)
    for i, held in enumerate((pinned, None)):
        for name, a, b, j in zip(("params", "mu", "nu"), got["states"][i],
                                 ref["states"][i], jstates[i]):
            _close_state(a, b, held, f"{name} {i}")
            _close_state(_as_jax(a), _as_jax_tree(j),
                         held and jpinned, f"{name} {i} vs jax")


@pytest.mark.parametrize("fam,mesh", CASES)
def test_whole_leaves_get_the_unsharded_gradient_on_every_rank(fam, mesh):
    """A leaf the rules leave whole acts on values invariant over
    ``model``: each rank's gradient is the whole of it, and after the sum
    over the batch axes every piece equals the unsharded gradient (a sum
    over ``model`` would make it m times that). Each family's own such
    leaves are among them, and get a nonzero gradient."""
    ref, got = _port_run(fam), _port_run(fam, mesh)
    whole = [k for k, sp in got["plan"].specs.items()
             if all(e is None for e in sp)]
    want = {"ssm": ("blocks.0.conv_w", "blocks.1.A_log", "blocks.0.D",
                    "blocks.1.dt_bias", "blocks.0.norm", "ln_f.scale"),
            "hybrid": ("blocks.3.conv_b", "shared.ln1.scale",
                       "shared.ln2.scale", "blocks.2.ln.scale"),
            "encdec": ("enc_pos", "dec_pos", "ln_enc.bias",
                       "dec_blocks.1.ln2.scale"),
            "vlm": ("cross_blocks.0.gate_attn", "cross_blocks.1.gate_mlp",
                    "cross_blocks.1.ln1.scale", "blocks.1.ln2.scale")}[fam]
    assert set(want) <= set(whole)
    for k in whole:
        r = ref["grads"][0][k].numpy()
        if k in want:
            assert np.abs(r).max() > 0, k
        for piece in got["pieces"][k]:
            np.testing.assert_allclose(piece.numpy(), r, rtol=GRAD_RTOL,
                                       atol=GRAD_RTOL * np.abs(r).max(),
                                       err_msg=k)


@pytest.mark.parametrize("fam,mesh", CASES)
def test_collective_bytes_equal_the_specs(fam, mesh):
    """The first step's collectives move, op by op and axis by axis, the
    bytes ``expected_collective_bytes`` works out from the specs and
    shapes: the mamba gathers as often as their nested layers run, the
    shared block's per application, the encoder's and the cross reads'."""
    got = _port_run(fam, mesh)
    assert got["bytes"] == PL.expected_collective_bytes(
        got["plan"], BATCH // MB, SEQ, MB)
    if mesh == "2x2":
        assert got["bytes"]["all_gather:data"] > 0
        assert got["bytes"]["reduce_scatter:data"] > 0


@pytest.mark.parametrize("fam,mesh", CASES)
def test_kernel_calls_per_device_equal_remat_calls(fam, mesh):
    """K3, its backward and the SSD run once per device for each call of
    the unsharded step (``remat_calls`` x microbatches: zamba2's and the
    VLM's nested layers three times)."""
    got, ref = _port_run(fam, mesh), _port_run(fam)
    n = len(got["state"].mesh.devices)
    want = {k: v * MB for k, v in remat_calls(got["plan"].cfg).items()}
    assert ref["calls"] == want
    assert got["calls"] == {k: v * n for k, v in want.items()}


@pytest.mark.parametrize("fam", FAMILIES)
def test_pieces_have_their_specs_shapes(fam):
    """Each state leaf's pieces have the shapes its spec gives (a stack's
    layer its piece of the stacked leaf's spec; ``shared.*``, ``enc_pos``
    and ``dec_pos`` none) and the model's own masters are ``meta``."""
    st, plan = _port_run(fam, "2x2")["state"], _port_run(fam, "2x2")["plan"]
    assert all(p.device.type == "meta" for p in st.model.parameters())
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
    split = {"ssm": "blocks.0.in_proj", "hybrid": "shared.attn.wq",
             "encdec": "dec_blocks.0.cross_attn.wk",
             "vlm": "cross_blocks.1.attn.wq"}[fam]
    assert st.shards[split].splits


@pytest.mark.parametrize("fam", ["hybrid", "encdec", "vlm", "ssm"])
def test_padded_heads_and_lanes_get_zero_gradient(fam, monkeypatch):
    """On (1, 3) the 4 heads run as 6 (scheme ``replicate``, the cross
    reads' too) and the vocab as 258 lanes (mamba2's tied head too): the
    padded rows of every padded tensor get exactly zero gradient."""
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
    st = _placed(fam, "1x3")[1]
    plan = PL.MeshPlan(st.model, st.mesh)
    assert (plan.hp, plan.vp) == ((0 if fam == "ssm" else 6), 258)
    params = {k: list(v.shards) for k, v in st.shards.items()}
    losses, _, _ = PL.sharded_loss(plan, params, _tb(_batch(st.model.cfg, 0)),
                                   remat=False)
    torch.autograd.grad(losses, [p for ps in params.values() for p in ps])
    kinds = set()
    for out, dim, n in padded:
        if out.grad is None:
            continue
        kinds.add((tuple(out.shape), dim))
        extra = out.grad.narrow(dim, n, out.shape[dim] - n)
        assert extra.abs().max() == 0, (tuple(out.shape), dim)
    assert any(s[d] == 258 for s, d in kinds)
    assert (fam == "ssm") != any(s[d] == 6 for s, d in kinds)


@pytest.mark.parametrize("fam,over,media,remat,shape", [
    # 6 heads over model 4: head_dim split, kv heads over it, FSDP
    ("hybrid", dict(n_heads=6, n_kv_heads=3), True, True, (2, 4)),
    ("encdec", dict(n_heads=6, n_kv_heads=6, d_model=66, d_ff=132), True,
     True, (2, 4)),
    # a D model does not divide: tok and the tied head split over data
    ("ssm", dict(d_model=80), True, True, (2, 4)),
    # the VLM without media: gated causal self-attention in its cross layers
    ("vlm", {}, False, True, (2, 2)),
    # remat off: every layer once
    ("vlm", {}, True, False, (2, 2)),
    ("hybrid", {}, True, False, (1, 3))])
def test_other_paths_equal_unsharded_and_the_specs(fam, over, media, remat,
                                                    shape, monkeypatch):
    """The ``headdim`` scheme, a D that ``model`` does not divide, the VLM
    without media and remat off: the step's loss within 1e-5 and grad norm
    within 1e-4 relative of the unsharded one's, and its bytes those the
    specs give."""
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "8")
    cfg = family_cfg(fam, get_config, **over)
    b = _tb(_batch(cfg, 0, media=media))
    out = []
    for par in (None, ParallelConfig(shape, ("data", "model"))):
        model = build_model(cfg, device="cpu", max_seq=SEQ).init(3)
        if model.is_vlm:
            _seed_gates(model)
        opt = AdamW(lr=warmup_cosine(LR, 1, 3))
        st = init_train_state(model, opt, None, parallel=par)
        step = make_train_step(model, opt, microbatches=MB, remat=remat,
                               mesh=st.mesh)
        C.reset_collective_counts()
        st, m = step(st, b)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    assert C.collective_bytes() == PL.expected_collective_bytes(
        PL.MeshPlan(model, st.mesh), BATCH // MB, SEQ, MB, remat=remat)
    assert out[1][0] == pytest.approx(out[0][0], rel=1e-5)
    assert out[1][1] == pytest.approx(out[0][1], rel=1e-4)


def _seed_gates(model, seed=7):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for cb in model.cross_blocks:
            for g in (cb.gate_attn, cb.gate_mlp):
                g.copy_(0.3 + 0.9 * torch.rand((), generator=gen))


def _placed(fam, mesh, seed=0):
    model = build_model(family_cfg(fam, get_config), device="cpu",
                        max_seq=SEQ).init(seed)
    if model.is_vlm:
        _seed_gates(model)
    opt = AdamW(lr=warmup_cosine(LR, 1, 3))
    st = init_train_state(model, opt, None,
                          parallel=ParallelConfig(*MESHES[mesh]))
    return model, st, make_train_step(model, opt, microbatches=MB,
                                      mesh=st.mesh)


@pytest.mark.parametrize("fam", FAMILIES)
def test_sharded_steps_repeat_bit_for_bit(fam):
    """Two runs of two sharded steps from one seed: the same loss, grad
    norm and pieces, bit for bit (every sum in a fixed order)."""
    out = []
    for _ in range(2):
        model, st, step = _placed(fam, "2x2")
        for i in range(STEPS):
            st, m = step(st, _tb(_batch(model.cfg, i)))
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    {k: v.shards for k, v in st.shards.items()}))
    assert out[0][:2] == out[1][:2]
    for k, v in out[0][2].items():
        assert all(torch.equal(a, b) for a, b in zip(v, out[1][2][k])), k


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


@pytest.mark.parametrize("fam", FAMILIES)
def test_sharded_checkpoint_equals_unsharded_and_restores(fam, tmp_path):
    """A state placed on (2, 2) writes the JAX layout's whole leaves
    (zamba2's ``shared/``, whisper's stacks and position tables, the VLM's
    ``cross_blocks/`` and gates), file for file those of the same state
    unplaced; after a step it restores onto a mesh (each leaf placed by the
    rules, every piece equal) and the JAX package's ``restore`` reads it."""
    model = build_model(family_cfg(fam, get_config), device="cpu",
                        max_seq=SEQ)
    opt = AdamW(lr=warmup_cosine(LR, 1, 3))
    st = init_train_state(model, opt, 0)
    ckpt.save(str(tmp_path / "a"), 0, st)
    mesh = ParallelConfig(*MESHES["2x2"]).build_mesh(device="cpu")
    placed = place_train_state(st, mesh)
    ckpt.save(str(tmp_path / "b"), 0, placed)
    fa, fb = _files(str(tmp_path / "a")), _files(str(tmp_path / "b"))
    assert fa.keys() == fb.keys() and len(fa) > 10
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k]), k
    step = make_train_step(model, opt, microbatches=MB, mesh=mesh)
    placed, _ = step(placed, _tb(_batch(model.cfg, 0)))
    ckpt.save(str(tmp_path / "c"), 1, placed)
    _, fresh, _ = _placed(fam, "2x2", seed=5)
    back = ckpt.restore(str(tmp_path / "c"), fresh)
    assert back.step == 1 and back.mesh is fresh.mesh
    for tree, want in ((back.shards, placed.shards),
                       (back.opt.mu, placed.opt.mu),
                       (back.opt.nu, placed.opt.nu)):
        for k, v in tree.items():
            assert v.sharding.spec == want[k].sharding.spec, k
            assert all(torch.equal(x, y) for x, y in
                       zip(v.shards, want[k].shards)), k
    jm = jbuild(family_cfg(fam, jget))
    tmpl = _jax_state(jm, JAdamW(), 0)
    js = jckpt.restore(str(tmp_path / "c"), tmpl)
    assert int(js.step) == 1
    want = _as_jax(placed.params)
    got = _as_jax_tree(js.params)
    assert got.keys() == want.keys()
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


@pytest.mark.parametrize("fam", ["hybrid", "vlm", "encdec"])
def test_launch_train_takes_the_mesh_branch(fam, monkeypatch):
    """With four virtual devices ``launch.train`` places the state on the
    mesh and trains zamba2-2.7b and the VLM (its batches without media, as
    the JAX launcher's) through the sharded step, the loss that of one
    device within 1e-5; whisper-medium without media is refused at its
    first step, as on one device."""
    from repro_torch.launch import train as launcher
    args = ["--arch", ARCHS[fam], "--device", "cpu", "--steps", "2",
            "--seq", "16", "--batch", "4", "--microbatches", "2"]
    meshes = []

    def mesh_2x2(**kw):
        meshes.append(ParallelConfig(*MESHES["2x2"]).build_mesh(
            device=kw["device"]))
        return meshes[-1]
    monkeypatch.setattr(launcher, "make_production_mesh", mesh_2x2)
    if fam == "encdec":
        with pytest.raises(ValueError, match="takes media"):
            launcher.main(args)
        assert len(meshes) == 1
        return
    sharded = launcher.main(args)
    assert len(meshes) == 1
    monkeypatch.delenv(VIRTUAL_DEVICES_ENV)
    one = launcher.main(args)
    assert sharded["steps"] == one["steps"] == 2
    assert sharded["final_loss"] == pytest.approx(one["final_loss"],
                                                  rel=1e-5)
