"""The port's checkpoint writer: twins of ``tests/test_checkpoint.py``'s
first six tests, and checkpoints that cross between the port and the JAX
package both ways.

* The round trip, ``latest_step`` and ``prune``, ``save_async``, an
  incomplete step ignored, structure and shape mismatches raising.
* The leaf keys of JAX's ``_flatten`` (``params/w``; a NamedTuple's field
  as ``.field``), the layout (``step_%09d/``, ``manifest.json``,
  ``leaf_%05d.npy``, ``LATEST``).
* A ``TrainState`` of reduced stablelm-1.6b and granite-moe-3b-a800m after
  two steps, written by the port and restored by JAX's ``restore`` into
  its own ``TrainState``, and the other way round: every leaf equal
  (parameters and moments stacked on the layer axis, the counters int32,
  the hot mask bool).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.optim import AdamW as JAdamW
from repro.train import init_train_state as jinit
from repro.train import make_train_step as jmake
from repro_torch import checkpoint as ckpt
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticSource
from repro_torch.models import build_model
from repro_torch.models.layout import jax_tree, numpy_leaf
from repro_torch.optim import AdamW
from repro_torch.train import init_train_state, make_train_step

torch.set_num_threads(1)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((8, 16), generator=g),
                   "b": torch.zeros((16,), dtype=torch.float32)},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def test_save_restore_roundtrip(tmp_path):
    tree = _tree()
    ckpt.save(str(tmp_path), 7, tree)
    out = ckpt.restore(str(tmp_path), tree)
    for k in ("w", "b"):
        assert torch.equal(out["params"][k], tree["params"][k])
    assert out["step"].dtype == torch.int32 and int(out["step"]) == 7
    names = sorted(os.listdir(tmp_path / "step_000000007"))
    assert names == ["leaf_00000.npy", "leaf_00001.npy", "leaf_00002.npy",
                     "manifest.json"]
    assert (tmp_path / "LATEST").read_text() == "step_000000007"


def test_latest_and_prune(tmp_path):
    for s in (10, 20, 30, 40):
        ckpt.save(str(tmp_path), s, _tree())
    assert ckpt.latest_step(str(tmp_path)) == 40
    ckpt.prune(str(tmp_path), keep=2)
    assert ckpt.list_steps(str(tmp_path)) == [30, 40]


def test_async_save(tmp_path):
    tree = _tree()
    t = ckpt.save_async(str(tmp_path), 5, tree)
    tree["params"]["w"].add_(1.0)   # the snapshot was taken at the call
    t.join()
    assert ckpt.latest_step(str(tmp_path)) == 5
    out = ckpt.restore(str(tmp_path), _tree())
    assert torch.equal(out["params"]["w"], _tree()["params"]["w"])


def test_incomplete_checkpoint_ignored(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    # a crash mid-save: a .tmp dir + a stale LATEST pointing at junk
    os.makedirs(tmp_path / "step_000000009.tmp")
    with open(tmp_path / "LATEST", "w") as f:
        f.write("step_000000009")
    assert ckpt.latest_step(str(tmp_path)) is None  # junk rejected
    assert ckpt.list_steps(str(tmp_path)) == [1]    # real one still there


def test_structure_mismatch_raises(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    bad = {"params": {"w": torch.zeros((8, 16))}, "step": torch.tensor(0)}
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore(str(tmp_path), bad)


def test_shape_mismatch_raises(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    bad = _tree()
    bad["params"]["w"] = torch.zeros((4, 16))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), bad)


def test_plain_trees_cross_both_ways(tmp_path):
    """A dict tree written by one package is read by the other, key for
    key (JAX's ``_flatten`` keys)."""
    tree = _tree(1)
    ckpt.save(str(tmp_path / "port"), 3, tree)
    jtree = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)
    out = jckpt.restore(str(tmp_path / "port"), jtree)
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(out)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jckpt.save(str(tmp_path / "jax"), 4, jtree)
    back = ckpt.restore(str(tmp_path / "jax"), _tree(2))
    for k in ("w", "b"):
        assert torch.equal(back["params"][k], tree["params"][k])


# ---------------------------------------------------------------------------
# TrainState across the two packages
# ---------------------------------------------------------------------------


def _states(arch, mode):
    """The JAX and the port's train states of one model after two steps on
    the same batches, and fresh ones to restore into."""
    kw = {"dispatch_mode": mode} if mode else {}
    n_hot = 2 if mode else 0
    jcfg = jget(arch).reduced()
    jm = jbuild(jcfg, **kw)
    jopt = JAdamW(lr=1e-3)
    jst = jinit(jm, jopt, jax.random.key(1), 32, n_hot_experts=n_hot)
    jstep = jax.jit(jmake(jm, jopt, n_hot_experts=n_hot))
    tm = params_from_numpy(jax.tree.map(np.asarray, jst.params),
                           build_model(get_config(arch).reduced(),
                                       device="cpu", **kw))
    opt = AdamW(lr=1e-3)
    st = init_train_state(tm, opt, None, n_hot)
    step = make_train_step(tm, opt, n_hot_experts=n_hot)
    src = SyntheticSource(DataConfig(16, 4, jcfg.vocab))
    for i in range(2):
        b = src.batch_at(i)
        jst, _ = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()})
        st, _ = step(st, {k: torch.as_tensor(v) for k, v in b.items()})
    fresh_j = jinit(jm, jopt, jax.random.key(9), 32, n_hot_experts=n_hot)
    fresh_t = init_train_state(
        build_model(get_config(arch).reduced(), device="cpu", **kw), opt, 9,
        n_hot)
    return jst, st, fresh_j, fresh_t


def _assert_same(jstate, tstate):
    """Every leaf of the JAX state equal to the port state's JAX tree."""
    want = jax.tree_util.tree_leaves_with_path(jstate)
    got = dict(ckpt.checkpoint._flatten(ckpt.checkpoint._host_tree(tstate)))
    flat_want = jckpt.checkpoint._flatten(jstate)
    assert set(got) == set(flat_want)
    assert len(want) == len(got)
    for key, leaf in flat_want.items():
        a = np.asarray(leaf)
        assert got[key].dtype == a.dtype, key
        np.testing.assert_array_equal(got[key], a, err_msg=key)


@pytest.mark.parametrize("arch,mode", [("stablelm-1.6b", None),
                                       ("granite-moe-3b-a800m", "adaptive")])
def test_train_state_crosses_both_ways(tmp_path, arch, mode):
    jst, st, fresh_j, fresh_t = _states(arch, mode)
    # the port writes; JAX restores into its own TrainState
    ckpt.save(str(tmp_path / "port"), 2, st)
    manifest = (tmp_path / "port" / "step_000000002" / "manifest.json")
    assert manifest.is_file()
    back_j = jckpt.restore(str(tmp_path / "port"), fresh_j)
    _assert_same(back_j, st)
    assert int(back_j.step) == 2 and int(back_j.opt.step) == 2
    # JAX writes; the port restores into a fresh TrainState (its model's
    # parameters loaded in place)
    jckpt.save(str(tmp_path / "jax"), 2, jst)
    back_t = ckpt.restore(str(tmp_path / "jax"), fresh_t)
    assert back_t.model is fresh_t.model
    _assert_same(jst, back_t)
    assert back_t.step == 2 and back_t.opt.step == 2
    if mode:
        assert back_t.expert_counts.dtype == torch.int64
        assert back_t.hot_mask.dtype == torch.bool
    params = jax_tree(back_t.model.named_parameters(), numpy_leaf)
    np.testing.assert_array_equal(params["embed"]["tok"],
                                  np.asarray(jst.params["embed"]["tok"]))
