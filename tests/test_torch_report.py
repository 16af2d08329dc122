"""The port's dry-run report (``repro_torch.launch.report``) prints the JAX
package's text for the same records: the same two tables, rows in the
same order, the same numbers, ``build`` where the JAX package's time column
says ``compile`` (the port builds its cells on the meta device where JAX
compiles them). CPU."""
import json
import sys

import pytest

from repro.configs import ALL_SHAPES as J_SHAPES
from repro.configs import ARCHS as J_ARCHS
from repro.launch import report as JREP
from repro_torch.configs import ALL_SHAPES, ARCHS
from repro_torch.launch import dryrun
from repro_torch.launch import report as REP


def _records():
    """Every status a sweep writes: ok (with and without a roofline block),
    skipped, error, and cells with no record."""
    recs = []
    for i, arch in enumerate(J_ARCHS):
        for j, shape in enumerate(J_SHAPES):
            if (i + j) % 7 == 6:
                continue            # MISSING
            if shape.name == "long_500k" and i % 2:
                recs.append({"arch": arch, "shape": shape.name,
                             "status": "skipped", "reason": "documented"})
                continue
            if (i * 3 + j) % 5 == 4:
                recs.append({"arch": arch, "shape": shape.name,
                             "status": "error", "error": "ValueError: x"})
                continue
            t = 1.5 + i + 0.25 * j
            mesh = {"per_device_gb": round(3.125 * t, 3),
                    "compile_s": t, "build_s": t}
            rec = {"arch": arch, "shape": shape.name, "status": "ok",
                   "single_pod": dict(mesh), "multi_pod": dict(
                       mesh, per_device_gb=round(1.5 * t, 3))}
            if j != 1:
                rec["roofline"] = {
                    "compute_s": 1.23e-3 * t, "memory_s": 4.56e-4 * j,
                    "collective_s": 7.8e-3 / t, "dominant": "compute",
                    "model_flops_ratio": 0.5 + 0.01 * i,
                    "roofline_fraction": 0.75 - 0.02 * j}
            recs.append(rec)
    return recs


@pytest.fixture
def record_dir(tmp_path):
    for r in _records():
        with open(tmp_path / f"{r['arch']}__{r['shape']}.json", "w") as f:
            json.dump(r, f)
    return tmp_path


def _main(module, record_dir, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["report", "--dir", str(record_dir)])
    module.main()
    return capsys.readouterr().out


def test_report_prints_jax_text(record_dir, capsys, monkeypatch):
    assert list(ARCHS) == list(J_ARCHS)
    assert [s.name for s in ALL_SHAPES] == [s.name for s in J_SHAPES]
    want = _main(JREP, record_dir, capsys, monkeypatch)
    got = _main(REP, record_dir, capsys, monkeypatch)
    assert "| ERROR |" in got and "| skipped* |" in got and "MISSING" in got
    assert got == want.replace("compile", "build")


def test_report_renders_dryrun_records(tmp_path, capsys, monkeypatch):
    """A skipped cell as ``dryrun.run_cell`` writes it (no probe runs)."""
    rec = dryrun.run_cell("qwen2-7b", "long_500k")
    assert rec["status"] == "skipped"
    assert "pure full-attention" in rec["reason"]
    with open(tmp_path / "qwen2-7b__long_500k.json", "w") as f:
        json.dump(rec, f)
    out = _main(REP, tmp_path, capsys, monkeypatch)
    assert "| qwen2-7b | long_500k | skipped* | | | | |" in out
    assert out.rstrip().endswith("cells: 0 ok / 1 skipped (documented) / "
                                 "0 error")


@pytest.fixture
def small_dryrun(monkeypatch):
    """``dryrun`` on reduced configs and 2 x 2 / 2 x 2 x 2 abstract meshes:
    the same code as a full sweep, at a size a test runs in seconds."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import make_abstract_mesh

    def mesh(*, multi_pod=False, device="meta"):
        assert device == "meta"
        return make_abstract_mesh((2, 2, 2) if multi_pod else (2, 2),
                                  ("pod", "data", "model")[-3 if multi_pod
                                                           else -2:])
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: get_config(arch).reduced())
    monkeypatch.setattr(dryrun, "make_production_mesh", mesh)


def test_dryrun_main_writes_records(small_dryrun, tmp_path, capsys,
                                    monkeypatch):
    out = tmp_path / "dry"
    for arch, shape in (("stablelm-1.6b", "train_4k"),
                        ("h2o-danube-3-4b", "decode_32k"),
                        ("mamba2-130m", "prefill_32k")):
        monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", arch,
                                          "--shape", shape, "--out",
                                          str(out)])
        if arch == "mamba2-130m":
            with pytest.raises(SystemExit, match="1 cell"):
                dryrun.main()
        else:
            dryrun.main()
    recs = REP.load(str(out))
    ok = recs[("stablelm-1.6b", "train_4k")]
    assert ok["status"] == "ok"
    for mesh in ("single_pod", "multi_pod"):
        mem = ok[mesh]["memory"]
        assert set(mem) == {"params", "opt_state", "batch", "transient_peak"}
        assert ok[mesh]["per_device_gb"] == round(sum(mem.values()) / 2**30,
                                                  3)
        assert ok[mesh]["fits_80gb"] and ok[mesh]["microbatches"] == 8
    assert set(ok["roofline"]) >= {"compute_s", "memory_s", "collective_s",
                                   "dominant", "model_flops_ratio"}
    dec = recs[("h2o-danube-3-4b", "decode_32k")]
    assert dec["single_pod"]["attention_scheme"] == "qheads_kvrepl"
    assert set(dec["single_pod"]["memory"]) == {"params", "cache", "batch",
                                                "transient_peak"}
    err = recs[("mamba2-130m", "prefill_32k")]
    assert err["status"] == "error" and "ROADMAP.md" in err["error"]
    text = REP.render(recs)
    assert "| stablelm-1.6b | train_4k | ok |" in text
    assert "| mamba2-130m | prefill_32k | ERROR |" in text
