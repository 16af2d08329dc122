"""The port's roofline tooling (``repro_torch.launch.roofline``) against the
JAX package's and against direct counts on the ``meta`` device.

* ``_combine`` equals JAX's; ``roofline_terms`` equals JAX's on the same
  metrics with JAX's ``PEAK_FLOPS`` / ``HBM_BW`` set to the H100's (JAX's
  50 GB/s ``ICI_BW`` is the port's inter-node link, where every axis of the
  production mesh goes); the collective term against a hand count of the
  link mapping;
* the affine reconstruction: ``probe_cell`` at depth 4 on a 2 x 2 abstract
  mesh against a direct meta count of the depth-4 cell. Serving cells
  (decode, the last prefill chunk) agree on every count. Train cells (a
  dense, an MoE and an enc-dec reduced config) agree on FLOPs (each
  dtype's and the slowest device's too), the transient peak of the dense
  ones and every collective but the gradient sum over the batch axes;
  their bytes (the mean, the slowest device's and the unattributed) and
  that sum differ by at most M
  times the optimizer part (the per-step part outside the microbatches),
  the JAX package's method carrying two known biases: it scales that part
  by the ``param_count`` ratio (the part is not proportional to the count:
  a norm's gradient is summed over the batch axes where a split leaf's is
  not) and measures the depth marginal at one microbatch, so the marginal
  holds the optimizer's too and is taken M times;
* FLOPs against XLA: the port's count of a reduced stablelm train probe on
  a 1 x 1 mesh is at most JAX's ``cost_analysis`` FLOPs of the same
  unrolled probe on the one CPU device (products only against every op)
  and at least ``XLA_SHARE`` of them (0.884 at depth 1, 0.874 at depth 2
  when measured).

* products by dtype: the per-dtype counts sum to the total, which equals
  ``FlopCounterMode``'s plus the kernels' own; a bf16 stablelm's fp32
  products are its vocab head's by hand, and the terms price each dtype at
  its peak on the slowest device's counts;
* device by device: on a (1, 3) mesh where qwen2's 4 reduced q heads pad
  to 6 (device 2 runs two zero q heads on a zero kv head) the slowest
  device's products equal the mean when serving and its bytes are within
  ``SERVE_BYTES_SPREAD`` (the vocab's padded lanes masked on the last
  device); a train step's within ``TRAIN_SPREAD`` (1.021 products, 1.018
  bytes when measured): the emulation recomputes every device's
  checkpointed layer in one region and stops after the last device's last
  saved value, so only that device skips its tail; at 256 devices one in
  256 does.

The JAX test ``test_scan_undercounts_unroll_doesnt`` has no twin: the port
has no scan. CPU."""
import dataclasses

import jax
import pytest
from torch.utils.flop_counter import FlopCounterMode

from repro.compat import cost_analysis_dict
from repro.configs import get_config as jget
from repro.configs import get_shape as jget_shape
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.launch import cells as JC
from repro.launch import roofline as JR
from repro.launch.mesh import make_host_mesh
from repro_torch.configs import ARCHS, get_config, get_shape
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed.sharding import make_abstract_mesh
from repro_torch.kernels import cost as COST
from repro_torch.launch import cells as C
from repro_torch.launch import roofline as R
from repro_torch.models import parallel as P
from repro_torch.models.model import build_model

XLA_SHARE = 0.8
SERVE_BYTES_SPREAD = 1.005
TRAIN_SPREAD = 1.03


def test_combine_equals_jax():
    a = {"flops": 10.0, "bytes": 4.0, "coll_all_reduce:data": 3.0}
    b = {"flops": 6.0, "coll": 2.0}
    for fa, fb in ((2.0, 3.0), (1.0, -1.0), (0.5, 7.0)):
        assert R._combine(a, b, fa, fb) == JR._combine(a, b, fa, fb)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_roofline_terms_equal_jax(arch, monkeypatch):
    monkeypatch.setattr(JR, "PEAK_FLOPS", R.PEAK_FLOPS)
    monkeypatch.setattr(JR, "HBM_BW", R.HBM_BW)
    assert JR.ICI_BW == R.NET_BW
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        for flops, nbytes, coll in ((989e12, 3.35e12 * 10, 50e9),
                                    (3.1e12, 2.2e9, 7.7e9), (0.0, 1.0, 0.0)):
            jm = {"flops": flops, "bytes": nbytes, "coll_bytes": coll}
            tm = dict(jm, **{"coll_all_gather:data": coll / 4,
                             "coll_all_reduce:model": coll * 3 / 4})
            got = R.roofline_terms(tm, get_config(arch), get_shape(shape))
            want = JR.roofline_terms(jm, jget(arch), jget_shape(shape))
            assert got.keys() == want.keys()
            for k, v in want.items():
                assert got[k] == pytest.approx(v, rel=1e-12), (k, shape)


def test_collective_term_by_hand():
    pod = R.SINGLE_POD
    for axes in (("data",), ("model",), ("data", "model")):
        assert R.axis_bandwidth(pod, axes) == 50e9
    multi = {"pod": 2, "data": 16, "model": 16}
    assert R.axis_bandwidth(multi, ("pod", "data")) == 50e9
    # inside one 8-GPU node every group rides NVLink
    small = {"data": 2, "model": 4}
    assert R.axis_bandwidth(small, ("model",)) == 450e9
    assert R.axis_bandwidth(small, ("data",)) == 450e9
    # model 8 fills a node; a data step of 8 leaves it
    wide = {"data": 2, "model": 8}
    assert R.axis_bandwidth(wide, ("model",)) == 450e9
    assert R.axis_bandwidth(wide, ("data",)) == 50e9
    assert R.axis_bandwidth(wide, ("data", "model")) == 50e9
    m = {"flops": 1.0, "bytes": 1.0, "coll_bytes": 5.0e9,
         "coll_all_gather:model": 4.5e9, "coll_all_reduce:data": 0.5e9}
    assert R.collective_seconds(m, wide) == pytest.approx(
        4.5e9 / 450e9 + 0.5e9 / 50e9)
    t = R.roofline_terms(m, get_config("stablelm-1.6b"),
                         get_shape("train_4k"), mesh_shape=wide)
    assert t["collective_s"] == pytest.approx(0.02)
    assert t["dominant"] == "collective"


MESH22 = ((2, 2), ("data", "model"))
TRAIN_CASES = (("stablelm-1.6b", {"n_layers": 4}),
               ("granite-moe-3b-a800m", {"n_layers": 4}),
               ("whisper-medium", {"n_layers": 4, "n_enc_layers": 4}))


def _direct(cfg, shape, mesh):
    step, args, _ = C.build_cell(cfg, shape, mesh)
    return R.count_step(step, args, len(mesh.devices))[0]


@pytest.mark.parametrize("shape", [ShapeSpec("decode_32k", 64, 4, "decode"),
                                   ShapeSpec("prefill_32k", 64, 4,
                                             "prefill")],
                         ids=lambda s: s.name)
def test_affine_reconstruction_serving_is_exact(shape):
    mesh = make_abstract_mesh(*MESH22)
    cfg = dataclasses.replace(get_config("qwen2-7b").reduced(), n_layers=4)
    assert R.probe_cell(cfg, shape, mesh) == _direct(cfg, shape, mesh)


@pytest.mark.parametrize("arch,depth", TRAIN_CASES, ids=lambda x: str(x))
def test_affine_reconstruction_train(arch, depth, monkeypatch):
    monkeypatch.setitem(C.TRAIN_MICROBATCHES, "default", 2)
    probes = {}
    lower = R._lower_metrics

    def kept(c, s, mesh, **kw):
        out = lower(c, s, mesh, **kw)
        probes[(c.n_layers, c.n_enc_layers, s.global_batch,
                kw["microbatches"])] = dict(out)
        return out
    monkeypatch.setattr(R, "_lower_metrics", kept)
    mesh = make_abstract_mesh(*MESH22)
    shape = ShapeSpec("train_4k", 16, 8, "train")
    cfg = dataclasses.replace(get_config(arch).reduced(), **depth)
    ext = R.probe_cell(cfg, shape, mesh)
    direct = _direct(cfg, shape, mesh)
    assert ext["flops"] == direct["flops"]
    approx = ("bytes", "bytes_rank_max", "bytes_unattributed", "coll_bytes",
              "coll_all_reduce:data", "peak_bytes")
    for k in set(ext) | set(direct):
        if k not in approx:
            assert ext.get(k) == direct.get(k), k
    if cfg.family == "dense":
        assert ext["peak_bytes"] == direct["peak_bytes"]
    # the optimizer part the reconstruction scales by the param ratio
    mb = C.TRAIN_MICROBATCHES["default"]
    probe = C.probe_config(cfg, C.depth_probes(cfg)[0][1])
    at = (probe.n_layers, probe.n_enc_layers)
    p11 = probes[at + (shape.global_batch // mb, 1)]
    p12 = probes[at + (2 * shape.global_batch // mb, 2)]
    ratio = cfg.param_count() / probe.param_count()
    for k in ("bytes", "bytes_rank_max", "bytes_unattributed", "coll_bytes",
              "coll_all_reduce:data"):
        opt = abs(2 * p11.get(k, 0) - p12.get(k, 0)) * ratio
        assert abs(ext[k] - direct[k]) <= mb * opt, (k, ext[k], direct[k],
                                                      opt)


def test_flops_at_most_xla():
    mesh = make_host_mesh()
    for depth in (1, 2):
        jcfg = dataclasses.replace(jget("stablelm-1.6b").reduced(),
                                   n_layers=depth)
        cfg = dataclasses.replace(get_config("stablelm-1.6b").reduced(),
                                  n_layers=depth)
        step, args, _ = JC.build_cell(jcfg, JShapeSpec("train_4k", 64, 4,
                                                       "train"), mesh,
                                      unroll=True, microbatches=1)
        # one device: the placements change no count
        args = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                            tuple(a for a in args if a is not None))
        xla = cost_analysis_dict(jax.jit(step).lower(*args).compile())["flops"]
        ours = R._lower_metrics(cfg, ShapeSpec("train_4k", 64, 4, "train"),
                                make_abstract_mesh((1, 1), ("data", "model")),
                                microbatches=1)["flops"]
        assert XLA_SHARE * xla <= ours <= xla, (depth, ours, xla)


def test_flops_by_dtype_equal_flop_counter():
    cfg = dataclasses.replace(get_config("stablelm-1.6b").reduced(),
                              n_layers=2, dtype="bfloat16")
    mesh = make_abstract_mesh(*MESH22)
    shape = ShapeSpec("train_4k", 16, 8, "train")
    n = len(mesh.devices)
    got = R.count_step(*C.build_cell(cfg, shape, mesh, microbatches=2)[:2],
                       n)[0]
    step, args, _ = C.build_cell(cfg, shape, mesh, microbatches=2)
    with FlopCounterMode(display=False) as fc, COST.KernelCounter() as kc:
        step(*args)
    assert got["flops"] * n == fc.get_total_flops() + kc.total("flops")
    assert got["flops:bf16"] + got["flops:fp32"] == got["flops"]
    # the fp32 head: its logits and their two gradients, 2 x tokens x D x V
    tokens = shape.global_batch * shape.seq_len
    assert got["flops:fp32"] * n == 3 * 2 * tokens * cfg.d_model * cfg.vocab
    terms = R.roofline_terms(got, cfg, shape)
    assert terms["compute_s"] == pytest.approx(
        got["flops_rank_max:bf16"] / 989e12
        + got["flops_rank_max:fp32"] / 67e12, rel=1e-12)
    assert terms["memory_s"] == pytest.approx(got["bytes_rank_max"] / 3.35e12,
                                              rel=1e-12)


def test_compute_seconds_by_dtype():
    m = {"flops": 3e12, "flops:bf16": 2e12, "flops:fp32": 1e12}
    assert R.compute_seconds(m) == pytest.approx(2e12 / 989e12 + 1e12 / 67e12)
    assert R.compute_seconds({"flops": 3e12}) == 3e12 / 989e12
    with pytest.raises(ValueError, match="float64"):
        R.compute_seconds({"flops": 1.0, "flops:float64": 1.0})


@pytest.mark.parametrize("step", ("decode", "prefill", "train"))
def test_rank_balance_on_a_padded_mesh(step):
    cfg = dataclasses.replace(get_config("qwen2-7b").reduced(), n_layers=2)
    mesh = make_abstract_mesh((1, 3), ("data", "model"))
    plan = P.MeshPlan(build_model(cfg, device="meta"), mesh)
    assert plan.hp == 6 and plan.kv_heads[2] == [cfg.n_kv_heads]
    shape = {"decode": ShapeSpec("decode_32k", 64, 6, "decode"),
             "prefill": ShapeSpec("prefill_32k", 64, 6, "prefill"),
             "train": ShapeSpec("train_4k", 16, 12, "train")}[step]
    got = _direct(cfg, shape, mesh) if step != "train" else \
        R.count_step(*C.build_cell(cfg, shape, mesh, microbatches=2)[:2],
                     3)[0]
    bal = R.rank_balance(got)
    if step == "train":
        assert 1.0 <= bal["flops_max_over_mean"] <= TRAIN_SPREAD, bal
        assert 1.0 <= bal["bytes_max_over_mean"] <= TRAIN_SPREAD, bal
    else:
        assert bal["flops_max_over_mean"] == 1.0, bal
        assert 1.0 <= bal["bytes_max_over_mean"] <= SERVE_BYTES_SPREAD, bal
    assert bal["flops_unattributed_share"] < 0.05, bal
