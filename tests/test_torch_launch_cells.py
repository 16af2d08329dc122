"""The port's dry-run cells (``repro_torch.launch.cells``), the shape specs
and the abstract trees against the JAX package, the kernel wrappers' meta
branch, and the dense family's sharded serving steps.

* ``ShapeSpec`` / ``ALL_SHAPES`` / ``shape_applicable`` (10 archs x 4
  shapes), ``TRAIN_MICROBATCHES``, ``PREFILL_CHUNK``, ``depth_probes``,
  ``probe_config`` and ``full_depth_units`` equal JAX's;
* ``input_specs`` / ``abstract_params`` equal ``jax.eval_shape``'s trees
  leaf by leaf (shape and dtype) for every applicable cell;
* per-device resident bytes on 16 x 16 and 2 x 16 x 16 equal those JAX's
  specs give for the same trees (the train state and batch of every train
  cell; the parameters and tokens of the dense serving cells, and their
  KV cache where the scheme splits heads); every serving cache equals a
  hand count of the kv heads a device holds;
* on ``meta`` each wrapper makes outputs of its plain version's shape and
  dtype, never loads the library (``build.load_library`` raises here), and
  counts its cost as the hand count;
* the serving steps of ``models.parallel`` on a CPU mesh of 2 x 2 virtual
  devices equal the single-device model's, and on 2 x 2 and 1 x 3 (padded
  heads, a zero kv head) JAX's ``chunk_prefill`` / ``decode_step`` on the
  same weights (fp32, reduced configs);
* ``cost.live_pairs``'s closed form equals a loop over the queries.

CPU; exact unless a tolerance is stated. The JAX trees are made once per
module."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import make_abstract_mesh as jax_abstract_mesh
from repro.configs import ALL_SHAPES as J_SHAPES
from repro.configs import get_config as jget
from repro.configs import shape_applicable as j_applicable
from repro.distributed.sharding import batch_pspec as j_batch_pspec
from repro.distributed.sharding import cache_pspec as j_cache_pspec
from repro.distributed.sharding import state_shardings as j_state_shardings
from repro.launch import cells as JC
from repro.models import abstract_params as j_abstract_params
from repro.models import build_model as j_build_model
from repro.models import input_specs as j_input_specs
from repro_torch import kernels as K
from repro_torch.configs import (ALL_SHAPES, ARCHS, SHAPES, get_config,
                                 get_shape, shape_applicable)
from repro_torch.distributed.sharding import (Mesh, make_abstract_mesh,
                                              tree_paths_and_leaves)
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import cost as COST
from repro_torch.launch import cells as C
from repro_torch.models import parallel as P
from repro_torch.models.model import (abstract_params, build_model,
                                      input_specs)

torch.set_num_threads(1)
MESHES = ((16, 16), (2, 16, 16))
DENSE_SERVE = ("stablelm-1.6b", "qwen2-7b", "nemotron-4-15b",
               "h2o-danube-3-4b")


def _axes(shape):
    return ("pod", "data", "model")[-len(shape):]


def _cells():
    return [(a, s.name) for a in sorted(ARCHS) for s in ALL_SHAPES
            if shape_applicable(get_config(a), s)[0]]


def _jflat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "name",
                                                       getattr(p, "idx", p))))
                       for p in path)
        out[key] = (tuple(leaf.shape), jnp.dtype(leaf.dtype).name)
    return out


def _tflat(tree):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree_paths_and_leaves(tree)}


@pytest.fixture(scope="module")
def jax_trees():
    """JAX's abstract inputs of every applicable cell and parameters of
    every arch (``jax.eval_shape``), flattened."""
    inputs = {(a, s): _jflat(j_input_specs(jget(a), get_shape_j(s)))
              for a, s in _cells()}
    params = {a: _jflat(j_abstract_params(jget(a), J_SHAPES[0]))
              for a in sorted(ARCHS)}
    return inputs, params


def get_shape_j(name):
    return next(s for s in J_SHAPES if s.name == name)


# ---------------------------------------------------------------------------
# shapes and cell settings
# ---------------------------------------------------------------------------


def test_shapes_equal_jax():
    assert [dataclasses.astuple(s) for s in ALL_SHAPES] == \
        [dataclasses.astuple(s) for s in J_SHAPES]
    assert list(SHAPES) == [s.name for s in J_SHAPES]
    assert get_shape("decode_32k") == SHAPES["decode_32k"]
    with pytest.raises(KeyError):
        get_shape("train_8k")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_shape_applicable_equal_jax(arch):
    for s, js in zip(ALL_SHAPES, J_SHAPES):
        assert shape_applicable(get_config(arch), s) == \
            j_applicable(jget(arch), js), (arch, s.name)


def test_cell_settings_equal_jax():
    assert C.TRAIN_MICROBATCHES == JC.TRAIN_MICROBATCHES
    assert C.PREFILL_CHUNK == JC.PREFILL_CHUNK
    for arch in sorted(ARCHS):
        cfg, jcfg = get_config(arch), jget(arch)
        assert C._n_hot(cfg) == JC._n_hot(jcfg)
        probes, jprobes = C.depth_probes(cfg), JC.depth_probes(jcfg)
        assert probes == jprobes, arch
        assert C.full_depth_units(cfg) == JC.full_depth_units(jcfg)
        for (_, kw, _), (_, jkw, _) in zip(probes, jprobes):
            assert dataclasses.asdict(C.probe_config(cfg, kw)) == \
                dataclasses.asdict(JC.probe_config(jcfg, jkw))


def test_depth_probe_configs_preserve_structure():
    """Twin of tests/test_roofline.py's."""
    for arch in ("qwen2-7b", "llama-3.2-vision-90b", "zamba2-2.7b",
                 "whisper-medium", "mamba2-130m"):
        cfg = get_config(arch)
        for _, kw, _ in C.depth_probes(cfg):
            pc = C.probe_config(cfg, kw)
            assert pc.family == cfg.family
            assert pc.d_model == cfg.d_model
            if cfg.family == "vlm":
                assert pc.n_layers % pc.cross_attn_every == 0
            if cfg.family == "hybrid":
                assert pc.n_layers % pc.hybrid_attn_every == 0
        units = C.full_depth_units(cfg)
        assert units == (cfg.n_layers, cfg.n_enc_layers) \
            if cfg.family == "encdec" else units >= 1


# ---------------------------------------------------------------------------
# abstract trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_abstract_trees_equal_jax(arch, jax_trees):
    inputs, params = jax_trees
    cfg = get_config(arch)
    for a, s in _cells():
        if a == arch:
            assert _tflat(input_specs(cfg, get_shape(s))) == inputs[(a, s)], s
    assert _tflat(abstract_params(cfg, get_shape("train_4k"))) == \
        params[arch]


def test_abstract_params_whisper_positions_follow_the_shape():
    cfg = get_config("whisper-medium")
    for s in ("train_4k", "decode_32k"):
        tree = abstract_params(cfg, get_shape(s))
        assert tree["dec_pos"].shape[0] == max(cfg.max_position,
                                               get_shape(s).seq_len)


# ---------------------------------------------------------------------------
# resident bytes
# ---------------------------------------------------------------------------


def _jax_local(shape, dtype, spec, mesh):
    n = np.dtype(dtype).itemsize
    for i, d in enumerate(shape):
        e = spec[i] if i < len(spec) else None
        axes = () if e is None else (e,) if isinstance(e, str) else tuple(e)
        for a in axes:
            d //= mesh.shape[a]
        n *= d
    return n


def _jax_resident(arch, shape_name, mesh_shape):
    """Per-device bytes of JAX's train state (masters and moments) and batch
    for a train cell, or its parameters and tokens (and the KV cache) for a
    serving cell, from JAX's specs."""
    cfg, shape = jget(arch), get_shape_j(shape_name)
    mesh = jax_abstract_mesh(mesh_shape, _axes(mesh_shape))
    model = j_build_model(cfg)
    out = {}
    if shape.step == "train":
        state = JC.abstract_train_state(cfg, model, JC.make_optimizer(),
                                        shape.seq_len)
        sh = j_state_shardings(cfg, mesh, state)
        parts = {"params": 0, "opt_state": 0}
        for (path, leaf), s in zip(
                jax.tree_util.tree_flatten_with_path(state)[0],
                jax.tree_util.tree_leaves(sh)):
            top = str(getattr(path[0], "name", path[0]))
            if top == "params":
                parts["params"] += _jax_local(leaf.shape, leaf.dtype,
                                              s.spec, mesh)
            elif top == "opt" and len(path) > 2:
                parts["opt_state"] += _jax_local(leaf.shape, leaf.dtype,
                                                 s.spec, mesh)
        specs = j_input_specs(cfg, shape)
        parts["batch"] = sum(_jax_local(
            v.shape, v.dtype, j_batch_pspec(cfg, mesh, k, v.shape), mesh)
            for k, v in specs.items())
        return parts
    params = j_abstract_params(cfg, shape)
    from repro.distributed.sharding import param_pspec as j_param_pspec
    from repro.distributed.sharding import tree_paths_and_leaves as jtree
    out["params"] = sum(_jax_local(v.shape, v.dtype, j_param_pspec(
        cfg, mesh, k, v.shape), mesh) for k, v in jtree(params))
    b = shape.global_batch
    if shape.step == "prefill":
        chunk = min(JC.PREFILL_CHUNK.get(cfg.name, JC.PREFILL_CHUNK[
            "default"]), shape.seq_len)
        toks = {"tokens": jax.ShapeDtypeStruct((b, chunk), jnp.int32)}
    else:
        toks = {"tokens": jax.ShapeDtypeStruct((b,), jnp.int32),
                "pos": jax.ShapeDtypeStruct((b,), jnp.int32)}
    out["batch"] = sum(_jax_local(v.shape, v.dtype, j_batch_pspec(
        cfg, mesh, k, v.shape), mesh) for k, v in toks.items())
    cache = jax.eval_shape(lambda: model.init_cache(
        b, shape.seq_len, jnp.dtype(cfg.dtype)))
    out["cache"] = sum(_jax_local(v.shape, v.dtype, j_cache_pspec(
        cfg, mesh, k, v.shape), mesh) for k, v in cache.items())
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_resident_bytes_equal_jax_train(arch):
    for ms in MESHES:
        mesh = make_abstract_mesh(ms, _axes(ms))
        got = C.resident_bytes(get_config(arch), get_shape("train_4k"), mesh)
        assert got == _jax_resident(arch, "train_4k", ms), (arch, ms)


# kv heads a device's cache holds on the 16-wide ``model`` axis, by hand:
# stablelm 32 / 32 heads split 2 a device (JAX's piece); qwen2's 28 q heads
# padded to 32 run 2 a device in GQA groups of 7, so devices 3 (q 6, 7) and
# 10 (q 20, 21) read two kv heads; nemotron's 3 q heads a device (48 / 8:
# groups of 6) and h2o-danube's 2 (32 / 8: groups of 4) read one
SERVE_KV_HEADS = {"stablelm-1.6b": 2, "qwen2-7b": 2, "nemotron-4-15b": 1,
                  "h2o-danube-3-4b": 1}


def _hand_cache_bytes(arch, shape_name, mesh_shape):
    """K and V of JAX's cache ``[L, B, S, Hkv, Dh]``, each device holding
    the rows of JAX's batch split and ``SERVE_KV_HEADS`` heads whole."""
    cfg, shape = jget(arch), get_shape_j(shape_name)
    mesh = jax_abstract_mesh(mesh_shape, _axes(mesh_shape))
    cache = jax.eval_shape(lambda: j_build_model(cfg).init_cache(
        shape.global_batch, shape.seq_len, jnp.dtype(cfg.dtype)))
    total = 0
    for k in ("k", "v"):
        n_l, b, s, _, dh = cache[k].shape
        rows = j_cache_pspec(cfg, mesh, k, cache[k].shape)[1]
        for a in () if rows is None else (rows,) if isinstance(rows, str) \
                else rows:
            b //= mesh.shape[a]
        total += n_l * b * s * SERVE_KV_HEADS[arch] * dh * \
            np.dtype(cache[k].dtype).itemsize
    return total


@pytest.mark.parametrize("arch", DENSE_SERVE)
def test_resident_bytes_equal_jax_serve(arch):
    """Every cache equals the hand count (JAX's rows a device, the kv heads
    of its q heads whole: ``ServePlan``); a ``heads`` scheme's is also
    JAX's piece, the others' more than JAX's sequence split."""
    cfg = get_config(arch)
    for ms in MESHES:
        mesh = make_abstract_mesh(ms, _axes(ms))
        plan = P.MeshPlan(build_model(cfg, device="meta"), mesh)
        assert max(len(h) for h in plan.kv_heads) == SERVE_KV_HEADS[arch] \
            or plan.scheme == "heads"
        for s in ("decode_32k", "prefill_32k"):
            got = C.resident_bytes(cfg, get_shape(s), mesh)
            want = _jax_resident(arch, s, ms)
            assert got["params"] == want["params"]
            assert got["batch"] == want["batch"]
            assert got["cache"] == _hand_cache_bytes(arch, s, ms), \
                (arch, ms, s)
            if plan.scheme == "heads":
                assert got["cache"] == want["cache"], (arch, ms, s)
            else:
                assert got["cache"] > want["cache"], (arch, ms, s)


# ---------------------------------------------------------------------------
# the wrappers on meta
# ---------------------------------------------------------------------------


@pytest.fixture
def no_library(monkeypatch):
    def refuse():
        raise AssertionError("a meta call reached build.load_library")
    monkeypatch.setattr(kbuild, "load_library", refuse)


def _meta(*xs):
    return [x.to("meta") for x in xs]


def test_k3_meta_branch(no_library):
    gen = torch.Generator().manual_seed(0)
    b, hq, hkv, s, t, d = 2, 4, 2, 48, 64, 16
    q = torch.randn(b, hq, s, d, generator=gen)
    k = torch.randn(b, hkv, t, d, generator=gen)
    v = torch.randn(b, hkv, t, d, generator=gen)
    plain = K.flash_attention(q, k, v, True, 8)
    plain_lse = K.flash_attention_lse(q, k, v, True, 8)[1]
    launches = K.launch_counts()
    with COST.KernelCounter() as kc:
        out = K.flash_attention(*_meta(q, k, v), True, 8)
        out2, lse = K.flash_attention_lse(*_meta(q, k, v), True, 8)
        dq, dk, dv = K.flash_attention_bwd(*_meta(q, k, v, plain, plain_lse,
                                                  plain), True, 8)
    assert K.launch_counts() == launches
    for got, want in ((out, plain), (out2, plain), (lse, plain_lse),
                      (dq, q), (dk, k), (dv, v)):
        assert got.device.type == "meta"
        assert (got.shape, got.dtype) == (want.shape, want.dtype)
    pairs = sum(min(qa, t - 1) - max(qa - 8 + 1, 0) + 1
                for qa in range(t - s, t))
    qkvo = (2 * b * hq * s * d + 2 * b * hkv * t * d) * 4
    assert kc.counts["flash_attention"] == dict(
        launches=2, flops=2 * 4 * d * hq * b * pairs,
        bytes=2 * qkvo + 4 * b * hq * s)
    assert kc.counts["flash_attention_bwd"] == dict(
        launches=1, flops=10 * d * hq * b * pairs,
        bytes=(4 * b * hq * s * d + 4 * b * hkv * t * d) * 4 + 4 * b * hq * s)


def test_k3_under_autograd_on_meta(no_library):
    q, k, v = (torch.empty(1, 2, 32, 16, device="meta", requires_grad=True)
               for _ in range(3))
    with COST.KernelCounter() as kc:
        out = K.FlashAttentionFunction.apply(q, k, v, True, 0)
        out.sum().backward()
    assert q.grad.shape == q.shape and q.grad.device.type == "meta"
    assert kc.launches() == {"flash_attention": 1, "flash_attention_bwd": 1}


def test_k1_meta_branch(no_library):
    gen = torch.Generator().manual_seed(1)
    n, w, rows = 12, 8, 20
    staging = torch.randn(n, w, generator=gen)
    dst = torch.randperm(rows, generator=gen)[:n]
    ok = torch.rand(n, generator=gen) < 0.5
    drained = K.staged_drain(staging, dst, ok, rows)
    gathered = K.staged_gather(drained, dst, ok)
    dest = torch.zeros(rows, w)
    launches = K.launch_counts()
    with COST.KernelCounter() as kc:
        got = K.staged_drain(*_meta(staging, dst, ok), rows)
        back = K.staged_gather(*_meta(drained, dst, ok))
        kept = K.staged_scatter(*_meta(dest, staging, dst, ok))
    assert K.launch_counts() == launches
    for a, want in ((got, drained), (back, gathered), (kept, dest)):
        assert (a.shape, a.dtype, a.device.type) == \
            (want.shape, want.dtype, "meta")
    routing = n * (8 + 1)
    assert kc.counts["staged_drain"] == dict(
        launches=1, flops=0, bytes=2 * n * w * 4 + routing)
    assert kc.counts["staged_scatter"] == kc.counts["staged_drain"]
    assert kc.counts["staged_gather"] == dict(
        launches=1, flops=0, bytes=2 * n * w * 4 + routing)


def test_k4_meta_branch(no_library):
    gen = torch.Generator().manual_seed(2)
    b, hq, hkv, t, d = 3, 8, 2, 40, 16
    q = torch.randn(b, hq, d, generator=gen)
    k = torch.randn(b, t, hkv, d, generator=gen)
    v = torch.randn(b, t, hkv, d, generator=gen)
    mask = torch.rand(b, t, generator=gen) < 0.7
    mask[:, 0] = True
    plain = K.flash_decode(q, k, v, mask)
    with COST.KernelCounter() as kc:
        out = K.flash_decode(*_meta(q, k, v, mask))
    assert (out.shape, out.dtype, out.device.type) == \
        (plain.shape, plain.dtype, "meta")
    # every key counted live: a meta tensor holds no mask values
    assert kc.counts["flash_decode"] == dict(
        launches=1, flops=4 * hq * b * t * d,
        bytes=b * t * hkv * d * 2 * 4 + 2 * b * hq * d * 4 + b * t)


def _live_pairs_by_loop(s, t, causal, window):
    total = 0
    for qa in range(t - s, t):
        hi = qa if causal else t - 1
        lo = max(qa - window + 1, 0) if window > 0 else 0
        total += max(hi - lo + 1, 0)
    return total


def test_live_pairs_closed_form_equals_a_loop():
    for s in range(0, 12):
        for t in range(0, 12):
            for causal in (True, False):
                for window in range(0, 14):
                    assert COST.live_pairs(s, t, causal, window) == \
                        _live_pairs_by_loop(s, t, causal, window), \
                        (s, t, causal, window)
    assert COST.live_pairs(4096, 32768, True, 4096) == \
        _live_pairs_by_loop(4096, 32768, True, 4096)


def test_cost_formulas_by_hand():
    assert COST.live_pairs(4, 4, True, 0) == 10
    assert COST.live_pairs(2, 6, True, 3) == 6
    assert COST.live_pairs(3, 5, False, 0) == 15
    assert COST.k1_cost(3, 5, 4, 2, 8, planes=6) == (0, 2 * 3 * 4 * 2 * 6
                                                     + 5 * 9)
    ms, by = COST.bound_ms(989e12, 0, torch.bfloat16)
    assert (ms, by) == (1e3, "operations")
    assert COST.bound_ms(0, 3.35e12, torch.float32) == (1e3, "bytes")


# ---------------------------------------------------------------------------
# cells on meta
# ---------------------------------------------------------------------------


def test_build_cell_refuses_what_waits():
    mesh = make_abstract_mesh((2, 2), ("data", "model"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A 3b"):
        C.build_cell(get_config("mamba2-130m").reduced(),
                     get_shape("long_500k"), mesh)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A 3a"):
        C.build_cell(get_config("granite-moe-3b-a800m").reduced(),
                     get_shape("decode_32k"), mesh)


def test_train_cell_runs_on_meta(no_library):
    from repro_torch.configs.base import ShapeSpec
    cfg = get_config("granite-moe-3b-a800m").reduced()
    mesh = make_abstract_mesh((2, 2), ("data", "model"))
    step, (state, batch), meta = C.build_cell(
        cfg, ShapeSpec("train_4k", 32, 8, "train"), mesh, microbatches=2)
    assert meta == {"arch": cfg.name, "shape": "train_4k", "step": "train",
                    "microbatches": 2}
    assert all(p.device.type == "meta" for p in state.model.parameters())
    with COST.KernelCounter() as kc:
        state, metrics = step(state, batch)
    assert metrics["loss"].device.type == "meta"
    assert set(kc.launches()) == {"flash_attention", "flash_attention_bwd",
                                  "staged_drain", "staged_gather"}


# ---------------------------------------------------------------------------
# the dense family's sharded serving steps on a CPU mesh
# ---------------------------------------------------------------------------


def _whole(ranks, mesh, rows, vocab):
    """The ``[B, V]`` logits of each device's ``[B / data, V / model]``."""
    d, m = mesh.shape["data"], mesh.shape["model"]
    lanes = ranks[0].shape[1]
    out = torch.zeros(rows, lanes * m)
    per = rows // d
    for r, lg in enumerate(ranks):
        c = mesh.coords(r)
        out[c["data"] * per:(c["data"] + 1) * per,
            c["model"] * lanes:(c["model"] + 1) * lanes] = lg
    return out[:, :vocab]


@pytest.mark.parametrize("arch", DENSE_SERVE)
def test_sharded_serving_equals_single_device(arch):
    cfg = get_config(arch).reduced()
    ref = build_model(cfg, device="cpu").init(3)
    weights = {k: v.clone() for k, v in ref.state_dict().items()}
    mesh = Mesh([torch.device("cpu")] * 4, (2, 2), ("data", "model"))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(weights)
    plan = P.ServePlan(model, mesh)
    gen = torch.Generator().manual_seed(4)
    b, s = 4, 48
    toks = torch.randint(0, cfg.vocab, (b, 32), generator=gen)
    # the last chunk of a prompt against the cache of its first
    cache = ref.init_cache(b, s)
    ref.chunk_prefill(cache, toks[:, :16], 0)
    placed = plan.place_cache({k: v.clone() for k, v in cache.items()})
    want, _ = ref.chunk_prefill(cache, toks[:, 16:], 16)
    got, _ = P.sharded_chunk_prefill(plan, placed, toks[:, 16:], 16)
    torch.testing.assert_close(_whole(got, mesh, b, cfg.vocab), want,
                               atol=1e-5, rtol=1e-5)
    # then a decode step at position 32
    tok = torch.randint(0, cfg.vocab, (b,), generator=gen)
    pos = torch.full((b,), 32)
    want, _ = ref.decode_step(cache, tok, pos)
    got, _ = P.sharded_decode_step(plan, placed, tok, pos)
    torch.testing.assert_close(_whole(got, mesh, b, cfg.vocab), want,
                               atol=1e-5, rtol=1e-5)


JAX_TOL = dict(atol=2e-4, rtol=1e-4)   # the two frameworks sum in orders
SERVE_MESHES = ((2, 2), (1, 3))


@pytest.mark.parametrize("mesh_shape", SERVE_MESHES, ids=lambda m: "x".join(
    map(str, m)))
@pytest.mark.parametrize("arch", DENSE_SERVE)
def test_sharded_serving_equals_jax(arch, mesh_shape):
    """The last prompt chunk and a decode step on a CPU mesh against the
    JAX package's ``chunk_prefill`` / ``decode_step`` with the same weights
    (initialised by JAX, nonzero qkv biases), fp32. On (1, 3) the 4 reduced
    q heads pad to 6: device 2 runs two zero q heads on a zero kv head."""
    from repro_torch.checkpoint import params_from_numpy

    jcfg = jget(arch).reduced()
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(5), 48)
    if jcfg.qkv_bias:
        rng = np.random.RandomState(0)
        attn = {k: (jnp.asarray(rng.randn(*v.shape).astype(np.float32) * 0.1)
                    if k in ("bq", "bk", "bv") else v)
                for k, v in jparams["blocks"]["attn"].items()}
        jparams = dict(jparams, blocks=dict(jparams["blocks"], attn=attn))
    cfg = get_config(arch).reduced()
    model = params_from_numpy(jax.tree.map(np.asarray, jparams),
                              build_model(cfg, device="cpu"))
    mesh = Mesh([torch.device("cpu")] * int(np.prod(mesh_shape)),
                mesh_shape, ("data", "model"))
    plan = P.ServePlan(model, mesh)
    if mesh_shape == (1, 3):
        assert plan.hp == 6 and plan.kv_heads[2] == [cfg.n_kv_heads]
    rng = np.random.RandomState(4)
    b, s = 4, 48
    toks = rng.randint(0, cfg.vocab, (b, 32)).astype(np.int32)
    jcache = jmodel.init_cache(b, s)
    _, jcache = jmodel.chunk_prefill(jparams, jcache, jnp.asarray(toks[:, :16]),
                                     0)
    placed = plan.place_cache({k: torch.from_numpy(np.array(v))
                               for k, v in jcache.items()})
    want, jcache = jmodel.chunk_prefill(jparams, jcache,
                                        jnp.asarray(toks[:, 16:]), 16)
    got, _ = P.sharded_chunk_prefill(plan, placed,
                                     torch.from_numpy(toks[:, 16:]), 16)
    np.testing.assert_allclose(_whole(got, mesh, b, cfg.vocab).numpy(),
                               np.asarray(want), **JAX_TOL)
    tok = rng.randint(0, cfg.vocab, (b,)).astype(np.int32)
    pos = np.full((b,), 32, np.int32)
    want, _ = jmodel.decode_step(jparams, jcache, jnp.asarray(tok),
                                 jnp.asarray(pos))
    got, _ = P.sharded_decode_step(plan, placed, torch.from_numpy(tok),
                                   torch.from_numpy(pos))
    np.testing.assert_allclose(_whole(got, mesh, b, cfg.vocab).numpy(),
                               np.asarray(want), **JAX_TOL)
