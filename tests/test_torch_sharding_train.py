"""The train half of ``repro_torch.distributed`` against the JAX package.

On the abstract 16 x 16 ``(data, model)`` and 2 x 16 x 16 ``(pod, data,
model)`` meshes (``make_abstract_mesh``: no device), for all ten archs,
every entry of the port's spec equals the JAX package's:

* ``param_pspec`` on every leaf of ``abstract_params(cfg, train_4k)``;
* ``cache_pspec`` on each arch's decode caches (``decode_32k`` at batch 128,
  ``long_500k`` at batch 1 for the subquadratic archs);
* ``state_shardings`` on the JAX ``TrainState`` tree, and ``batch_pspec`` /
  ``input_shardings`` on each cell's input-spec tree (``input_specs``);
* the paths ``tree_paths_and_leaves`` gives, on the JAX trees themselves.

Twins of ``tests/test_sharding.py`` (the scheme table, the lookup table never
vocab-split, ``long_500k``'s sequence split) and of
``tests/test_sharded_serving.py::test_parallel_config_drives_train_state_
shardings``; the port model's own parameter paths equal the JAX leaf paths
of each arch's reduced config; placed tensors split on several axes; the
collectives' values, gradients and byte counts; the production meshes.
CPU, exact.
"""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import get_shape
from repro.distributed import sharding as JS
from repro.models import abstract_params
from repro.models import build_model as jbuild
from repro.models import input_specs
from repro.optim import AdamW as JAdamW
from repro.train import init_train_state as jinit
from repro_torch.configs import ARCHS, get_config
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as S
from repro_torch.models import build_model
from repro_torch.models.layout import jax_tree

MESHES = {"single": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
CPU = torch.device("cpu")


def _meshes(which):
    shape, axes = MESHES[which]
    return JS.make_abstract_mesh(shape, axes), S.make_abstract_mesh(shape,
                                                                    axes)


def _spec(p):
    """A JAX ``PartitionSpec`` as the port's tuple."""
    return tuple(p)


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    """The JAX package's abstract params, train state and decode caches of
    ``arch`` at its full config (no device)."""
    cfg = jget(arch)
    params = abstract_params(cfg, get_shape("train_4k"))
    model = jbuild(cfg)
    n_hot = max(1, cfg.n_experts // 4) if cfg.n_experts else 0
    state = jax.eval_shape(lambda k: jinit(model, JAdamW(), k, 64, n_hot),
                           jax.ShapeDtypeStruct((2,), jnp.uint32))
    caches = {}
    for name, batch in (("decode_32k", 128), ("long_500k", 1)):
        if name == "long_500k" and not cfg.subquadratic:
            continue
        caches[name] = jax.eval_shape(
            lambda b=batch, s=get_shape(name).seq_len:
            model.init_cache(b, s, jnp.bfloat16))
    return params, state, caches


def _same_paths(tree):
    """The port's paths and leaves of a JAX tree equal JAX's."""
    want = [(p, tuple(v.shape)) for p, v in JS.tree_paths_and_leaves(tree)]
    got = [(p, tuple(v.shape)) for p, v in S.tree_paths_and_leaves(tree)]
    assert got == want
    return want


# ---------------------------------------------------------------------------
# the rules against JAX's, entry by entry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_pspec_equals_jax(arch, mesh):
    jm, tm = _meshes(mesh)
    params, _, _ = _abstract(arch)
    cfg, tcfg = jget(arch), get_config(arch)
    leaves = _same_paths(params)
    assert leaves
    for path, shape in leaves:
        want = _spec(JS.param_pspec(cfg, jm, path, shape))
        assert S.param_pspec(tcfg, tm, path, shape) == want, (path, shape)
    jsh = JS.param_shardings(cfg, jm, params)
    tsh = S.param_shardings(tcfg, tm, params)
    assert [(p, _spec(s.spec)) for p, s in JS.tree_paths_and_leaves(jsh)] \
        == [(p, s.spec) for p, s in S.tree_paths_and_leaves(tsh)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_pspec_equals_jax(arch, mesh):
    jm, tm = _meshes(mesh)
    _, _, caches = _abstract(arch)
    cfg, tcfg = jget(arch), get_config(arch)
    for name, cache in caches.items():
        for path, shape in _same_paths(cache):
            want = _spec(JS.cache_pspec(cfg, jm, path, shape))
            assert S.cache_pspec(tcfg, tm, path, shape) == want, (name, path)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_state_shardings_equal_jax(arch, mesh):
    jm, tm = _meshes(mesh)
    _, state, _ = _abstract(arch)
    cfg, tcfg = jget(arch), get_config(arch)
    _same_paths(state)
    want = [(p, _spec(s.spec)) for p, s in
            JS.tree_paths_and_leaves(JS.state_shardings(cfg, jm, state))]
    got = [(p, s.spec) for p, s in
           S.tree_paths_and_leaves(S.state_shardings(tcfg, tm, state))]
    assert got == want
    assert any(p.startswith("opt/mu/") for p, _ in got)
    # the placed tree keeps the state's structure (NamedTuple fields)
    placed = S.with_shardings(state, S.state_shardings(tcfg, tm, state))
    assert type(placed).__name__ == "TrainState"
    assert [(p, v.shape, v.sharding.spec) for p, v in
            S.tree_paths_and_leaves(placed)] == [
        (p, tuple(v.shape), s) for (p, v), (_, s) in
        zip(S.tree_paths_and_leaves(state), got)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_batch_pspec_and_input_shardings_equal_jax(arch, mesh):
    jm, tm = _meshes(mesh)
    cfg, tcfg = jget(arch), get_config(arch)
    for shape_name in ("train_4k", "prefill_32k", "decode_32k",
                       "long_500k"):
        shape = get_shape(shape_name)
        if shape_name == "long_500k" and not cfg.subquadratic:
            continue
        specs = input_specs(cfg, shape)
        want = [(p, tuple(v.shape), v.dtype, _spec(v.sharding.spec))
                for p, v in JS.tree_paths_and_leaves(
                    JS.input_shardings(cfg, jm, specs, shape.step))]
        got = [(p, v.shape, v.dtype, v.sharding.spec)
               for p, v in S.tree_paths_and_leaves(
                   S.input_shardings(tcfg, tm, specs, shape.step))]
        assert got == want, shape_name
        for p, v in JS.tree_paths_and_leaves(specs):
            if not p.startswith("cache"):
                assert S.batch_pspec(tcfg, tm, p, v.shape) == _spec(
                    JS.batch_pspec(cfg, jm, p, v.shape)), (shape_name, p)


# ---------------------------------------------------------------------------
# twins of tests/test_sharding.py
# ---------------------------------------------------------------------------


def test_attention_schemes_match_design_table():
    expected = {
        "nemotron-4-15b": "qheads_kvrepl", "h2o-danube-3-4b": "qheads_kvrepl",
        "qwen2-7b": "headdim", "stablelm-1.6b": "heads",
        "granite-moe-3b-a800m": "headdim",
        "qwen3-moe-235b-a22b": "qheads_kvrepl", "mamba2-130m": "none",
        "llama-3.2-vision-90b": "qheads_kvrepl", "whisper-medium": "heads",
        "zamba2-2.7b": "heads"}
    _, tm = _meshes("single")
    for arch, want in expected.items():
        assert S.attention_scheme(get_config(arch), tm) == want, arch


def test_lookup_table_never_vocab_sharded():
    for which in MESHES:
        _, tm = _meshes(which)
        for arch in sorted(ARCHS):
            cfg = get_config(arch)
            spec = S.param_pspec(cfg, tm, "embed/tok",
                                 (cfg.vocab, cfg.d_model))
            assert spec[0] is None, (arch, spec)


def test_long_500k_cache_seq_sharded():
    _, tm = _meshes("single")
    spec = S.cache_pspec(get_config("zamba2-2.7b"), tm, "k",
                         (9, 1, 524288, 32, 80))
    assert spec[2] == ("data", "model")
    _, tm3 = _meshes("multipod")
    spec = S.cache_pspec(get_config("zamba2-2.7b"), tm3, "k",
                         (9, 1, 524288, 32, 80))
    assert spec[2] == ("pod", "data", "model")


def test_parallel_config_drives_train_state_shardings(monkeypatch):
    """One ``ParallelConfig`` gives the train placement (and the serve
    side's cache placement) without translation."""
    monkeypatch.setenv(S.VIRTUAL_DEVICES_ENV, "2")
    pc = S.ParallelConfig.tensor(2)
    cfg = get_config("stablelm-1.6b").reduced()
    params, _, _ = _abstract("stablelm-1.6b")
    sh = pc.param_shardings(cfg, params, device="cpu")
    specs = {s.spec for _, s in S.tree_paths_and_leaves(sh)}
    assert any("model" in sp for sp in specs), specs
    assert S.ParallelConfig().param_shardings(cfg, params) is None
    assert S.ParallelConfig().state_shardings(cfg, params) is None
    st = pc.state_shardings(cfg, {"params": params}, device="cpu")
    assert [s.spec for _, s in S.tree_paths_and_leaves(st)] == [
        s.spec for _, s in S.tree_paths_and_leaves(sh)]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_port_parameter_paths_equal_jax_leaves(arch):
    """The port model's parameters map (``jax_key``) onto exactly the JAX
    model's leaf paths, each with its stacked shape."""
    jcfg = jget(arch).reduced()
    jm = jbuild(jcfg)
    jp = jax.eval_shape(lambda k: jm.init(k, 64),
                        jax.ShapeDtypeStruct((2,), jnp.uint32))
    want = {p: tuple(v.shape) for p, v in JS.tree_paths_and_leaves(jp)}
    tm = build_model(get_config(arch).reduced(), device="cpu", max_seq=64)
    tree = jax_tree(tm.named_parameters(), lambda values, stacked: torch.empty(
        ((len(values),) if stacked else ()) + tuple(values[0].shape),
        device="meta"))
    got = {p: tuple(v.shape) for p, v in S.tree_paths_and_leaves(tree)}
    assert got == want


# ---------------------------------------------------------------------------
# placed tensors on several axes
# ---------------------------------------------------------------------------


def test_sharded_tensor_splits_two_axes_and_tuples():
    mesh = S.Mesh([CPU] * 8, (2, 2, 2), ("pod", "data", "model"))
    x = torch.arange(8 * 6 * 4.).reshape(8, 6, 4)
    st = S.ShardedTensor.place(x, S.NamedSharding(mesh, ("data", "model",
                                                         None)))
    assert st.shape == x.shape and st.axis == (0, 1)
    assert [tuple(p.shape) for p in st.shards] == [(4, 3, 4)] * 8
    for i, p in enumerate(st.shards):
        c = mesh.coords(i)
        assert torch.equal(p, x[4 * c["data"]:4 * c["data"] + 4,
                                3 * c["model"]:3 * c["model"] + 3])
    assert [i for i, _ in st.read_group()] == [0, 1, 2, 3]
    assert torch.equal(st.gather(), x)
    # a tuple entry: pod major, then data
    tt = S.ShardedTensor.place(x, S.NamedSharding(mesh, (("pod", "data"),
                                                         None, "model")))
    for i, p in enumerate(tt.shards):
        c = mesh.coords(i)
        j = 2 * c["pod"] + c["data"]
        assert torch.equal(p, x[2 * j:2 * j + 2, :, 2 * c["model"]:
                                2 * c["model"] + 2])
    assert torch.equal(tt.gather(), x) and tt.shape == x.shape
    assert len(tt.read_group()) == 8
    assert [s for _, s in tt.slices(8, axis=0)][:3] == [
        slice(0, 2), slice(0, 2), slice(2, 4)]
    z = S.ShardedTensor.zeros((8, 6, 4), S.NamedSharding(
        mesh, (None, "data", "model")), torch.float32)
    assert [tuple(p.shape) for p in z.shards] == [(8, 3, 2)] * 8
    assert z.shape == (8, 6, 4) and z[1].sharding.spec == ("data", "model")
    assert z[1].shape == (6, 4)
    with pytest.raises(TypeError, match="leading axis"):
        st[0]
    with pytest.raises(ValueError, match="does not divide"):
        S.ShardedTensor.place(torch.zeros(3, 4), S.NamedSharding(
            mesh, ("data", None)))
    with pytest.raises(ValueError, match="which axis"):
        st.slices(8)


def test_make_abstract_mesh_and_production_meshes(monkeypatch):
    from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                         visible_devices)
    m = S.make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    assert m.lead.type == "meta" and len(m.devices) == 512
    monkeypatch.delenv(S.VIRTUAL_DEVICES_ENV, raising=False)
    assert visible_devices("cpu") == 1
    with pytest.raises(ValueError, match="needs 256 devices"):
        make_production_mesh(device="cpu")
    monkeypatch.setenv(S.VIRTUAL_DEVICES_ENV, "512")
    assert visible_devices("cpu") == 512
    pm = make_production_mesh(multi_pod=True, device="cpu")
    assert pm.shape == {"pod": 2, "data": 16, "model": 16}
    assert make_production_mesh(device="cpu").shape == {"data": 16,
                                                        "model": 16}
    hm = make_host_mesh()
    assert hm.shape == {"data": 1, "model": 1} and hm.devices == (CPU,)


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------


def _sm(batch_axes=("data",)):
    mesh = S.Mesh([CPU] * 4, (2, 2), ("data", "model"))
    return C.StepMesh(mesh, batch_axes)


def test_collectives_values_gradients_and_bytes():
    sm = _sm()
    C.reset_collective_counts()
    gen = torch.Generator().manual_seed(0)
    xs = [torch.randn(2, 3, generator=gen, requires_grad=True)
          for _ in range(4)]
    # all-gather over data (a batch axis): backward is a reduce-scatter
    out = C.all_gather(sm, xs, "data", 0, "w")
    assert torch.equal(out[0], torch.cat([xs[0], xs[2]]))
    assert torch.equal(out[3], torch.cat([xs[1], xs[3]]))
    gs = [torch.full((4, 3), float(r + 1)) for r in range(4)]
    g = torch.autograd.grad(out, xs, gs)
    assert torch.equal(g[0], torch.full((2, 3), 4.))   # devices 0 and 2
    assert torch.equal(g[3], torch.full((2, 3), 6.))   # devices 1 and 3
    # over model (invariant there): each piece its own device's part
    out = C.all_gather(sm, xs, "model", 1, "embed")
    g = torch.autograd.grad(out, xs, [torch.full((2, 6), float(r + 1))
                                      for r in range(4)])
    assert [float(x[0, 0]) for x in g] == [1., 2., 3., 4.]
    # psum: the sum everywhere, each input its own output's gradient
    out = C.psum(sm, xs, "model", "o")
    assert torch.equal(out[1], xs[0] + xs[1]) and \
        out[0].data_ptr() != out[1].data_ptr()
    g = torch.autograd.grad(out, xs, [torch.full((2, 3), float(r + 1))
                                      for r in range(4)])
    assert [float(x[0, 0]) for x in g] == [1., 2., 3., 4.]
    # copy_to: identity forward, gradients summed over the group
    out = C.copy_to(sm, xs, "model", "x")
    g = torch.autograd.grad(out, xs, [torch.full((2, 3), float(r + 1))
                                      for r in range(4)])
    assert [float(x[0, 0]) for x in g] == [3., 3., 7., 7.]
    # scatter_to: each model rank its part; the gradient gathered
    ys = [torch.randn(2, 4, generator=gen, requires_grad=True)
          for _ in range(4)]
    out = C.scatter_to(sm, ys, "model", 1, "w")
    assert torch.equal(out[1], ys[1][:, 2:])
    g = torch.autograd.grad(out, ys, [torch.full((2, 2), float(r + 1))
                                      for r in range(4)])
    assert torch.equal(g[0], torch.tensor([[1., 1., 2., 2.]] * 2))
    # pmax and the integer prefix carry no gradient
    m = C.pmax(sm, [x[0] for x in xs], "model", "mx")
    assert torch.equal(m[0], torch.maximum(xs[0][0], xs[1][0]).detach())
    pre = C.exclusive_prefix(sm, [torch.tensor([r, 1]) for r in range(4)],
                             "data", "slots")
    assert [p.tolist() for p in pre] == [[0, 0], [0, 0], [0, 1], [1, 1]]
    counts = {(c["op"], tuple(c["axes"]), c["what"]): c
              for c in C.collective_counts()}
    w = 4 * 3 * 4       # one whole of 4 x 3 fp32
    assert counts[("all_gather", ("data",), "w")]["bytes"] == 2 * w
    assert counts[("reduce_scatter", ("data",), "w")]["bytes"] == 2 * w
    assert counts[("all_reduce", ("model",), "o")]["bytes"] == \
        2 * 2 * (w // 2)
    assert C.collective_bytes()["all_gather:model"] > 0
    C.reset_collective_counts()
    assert C.collective_counts() == []
    # a group of one device moves nothing and counts nothing
    one = C.StepMesh(S.Mesh([CPU], (1, 1), ("data", "model")), ("data",))
    assert C.all_gather(one, xs[:1], "data", 0, "w")[0] is xs[0]
    assert C.collective_counts() == []
