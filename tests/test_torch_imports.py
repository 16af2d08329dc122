"""The port stands alone: no module under ``src/repro_torch/``, not
``chip_smoke.py`` and no script under ``tools/`` imports ``jax`` or
anything of the JAX package, and the GPU entry points refuse to carry on
on the CPU."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")
BANNED = ("jax", "jaxlib", "repro", "flax", "optax")


def _sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in [*os.walk(PKG),
                              *os.walk(os.path.join(ROOT, "tools"))]:
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    return roots


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_nothing_of_jax(path):
    bad = _imported_roots(path) & set(BANNED)
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {sorted(bad)}"


def test_package_has_every_ported_module():
    want = ["configs/base.py", "kernels/staged_scatter.py",
            "kernels/flash_decode.py", "kernels/flash_attention.py",
            "kernels/ops.py", "kernels/build.py",
            "kernels/csrc/staged_scatter.cu",
            "kernels/csrc/flash_decode_paged.cu",
            "kernels/csrc/flash_attention.cu", "kernels/csrc/flash_decode.cu",
            "kernels/cms.py", "kernels/csrc/cms.cu", "core/umtt.py",
            "core/unload.py", "core/staged_write.py", "core/simulator.py",
            "configs/h2o_danube_3_4b.py", "core/types.py",
            "core/ring.py", "core/monitor.py", "core/policy.py",
            "core/decision.py", "core/paths.py", "models/layers.py",
            "models/transformer.py", "models/model.py", "models/sampling.py",
            "models/prng.py", "kvcache/paged.py", "data/pipeline.py",
            "serve/traffic/sched.py", "serve/traffic/workload.py",
            "serve/traffic/harness.py",
            "serve/scheduler.py", "serve/api.py", "launch/serve.py",
            "checkpoint/checkpoint.py", "distributed/__init__.py",
            "distributed/sharding.py", "configs/paper_urdma.py",
            "configs/granite_moe_3b_a800m.py",
            "configs/qwen3_moe_235b_a22b.py", "models/moe.py",
            "models/moe_lm.py", "kernels/lru_scan.py",
            "kernels/csrc/lru_scan.cu", "configs/mamba2_130m.py",
            "configs/zamba2_2_7b.py", "models/mamba2.py",
            "models/ssm_lm.py", "models/layout.py", "optim/adamw.py",
            "train/trainer.py", "launch/train.py",
            "kernels/csrc/flash_attention_bwd.cu",
            "kernels/csrc/tma_wgmma.cuh", "kernels/cost.py",
            "launch/cells.py", "launch/roofline.py", "launch/dryrun.py",
            "launch/report.py"]
    missing = [w for w in want if not os.path.isfile(os.path.join(PKG, w))]
    assert not missing, missing


def _run(code, **kw):
    # CUDA_VISIBLE_DEVICES="" hides any GPU from the child, so the refusals
    # below are shown on every machine
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=240, **kw)


def test_importing_the_package_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{BANNED!r})\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "print('clean', len([k for k in sys.modules if "
        "k.startswith('repro_torch')]))\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("clean")


_REFUSALS = """
import pytest, torch
from repro_torch.core.paths import resolve_device
from repro_torch.serve import Engine, EngineConfig, build_model_and_params
assert not torch.cuda.is_available()
with pytest.raises(RuntimeError, match="is_available"):
    EngineConfig(max_seq=32, arch="stablelm-1.6b")      # device="cuda"
with pytest.raises(RuntimeError, match="is_available"):
    resolve_device("cuda")
with pytest.raises(RuntimeError, match="is_available"):
    build_model_and_params("stablelm-1.6b")
eng = Engine.from_config(EngineConfig(max_seq=32, arch="stablelm-1.6b",
                                      device="cpu"))
assert eng.scheduler.device.type == "cpu"
assert eng.attention == "reference"
print("refused")
"""


def test_cuda_device_raises_without_cuda():
    res = _run(_REFUSALS)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("refused")


def test_build_model_defaults_to_the_card():
    """``build_model(cfg)``, ``DecoderLM(cfg)`` and ``MoELM(cfg)`` with no
    device run on the card: without CUDA they raise and name
    ``device='cpu'``."""
    res = _run(
        "import pytest\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.models import build_model\n"
        "from repro_torch.models.transformer import DecoderLM\n"
        "cfg = get_config('h2o-danube-3-4b').reduced()\n"
        "for make in (build_model, DecoderLM):\n"
        "    with pytest.raises(RuntimeError, match=\"device='cpu'\"):\n"
        "        make(cfg)\n"
        "assert build_model(cfg, device='cpu').device.type == 'cpu'\n"
        "from repro_torch.models import MoELM\n"
        "moe = get_config('granite-moe-3b-a800m').reduced()\n"
        "for make in (build_model, MoELM):\n"
        "    with pytest.raises(RuntimeError, match=\"device='cpu'\"):\n"
        "        make(moe)\n"
        "print('refused')\n")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("refused")


def test_launcher_refuses_to_fall_back_to_cpu():
    res = _run("from repro_torch.launch.serve import main\n"
               "main(['--arch', 'stablelm-1.6b', '--batched'])\n")
    assert res.returncode != 0
    assert "is_available" in res.stderr


def test_launcher_serves_on_cpu_when_asked():
    res = _run("from repro_torch.launch.serve import main\n"
               "main(['--arch', 'stablelm-1.6b', '--device', 'cpu', "
               "'--batched', '--requests', '4', '--slots', '2', "
               "'--prompt-len', '8', '--gen-len', '6', '--max-seq', '32', "
               "'--segment-len', '4', '--ring-size', '2', '--page-size', "
               "'4'])\n")
    assert res.returncode == 0, res.stderr
    assert "served 4 requests / 24 tokens" in res.stdout
    assert "write-path stats" in res.stdout


def test_chip_smoke_fails_without_a_gpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=240)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_unported_archs_and_families_raise():
    """Every architecture the JAX package registers is ported (the VLM
    llama-3.2-vision-90b last), so ``NOT_PORTED`` is empty and only an
    unknown arch raises. Training is ported for every family: ``forward``
    and ``loss`` give logits ``[B, S, V]`` and a scalar for the dense, MoE,
    SSM, hybrid and VLM families (the VLM with or without media, as the
    reference), and for the encoder-decoder with its frames (without them
    it raises prefill's "takes media"); the dense class takes the dense
    and VLM families only."""
    from repro_torch.configs import ARCHS, NOT_PORTED, get_config
    from repro_torch.configs.base import VLM
    from repro_torch.models import DecoderLM, build_model
    import dataclasses
    import torch
    assert sorted(ARCHS) == ["granite-moe-3b-a800m", "h2o-danube-3-4b",
                             "llama-3.2-vision-90b", "mamba2-130m",
                             "nemotron-4-15b", "qwen2-7b",
                             "qwen3-moe-235b-a22b", "stablelm-1.6b",
                             "whisper-medium", "zamba2-2.7b"]
    assert NOT_PORTED == ()
    assert get_config("llama-3.2-vision-90b").family == VLM
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    vlm = dataclasses.replace(get_config("stablelm-1.6b").reduced(),
                              family=VLM, cross_attn_every=2)
    model = build_model(vlm, device="cpu")
    assert type(model) is DecoderLM and model.is_vlm
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    batch = {"tokens": tokens, "labels": tokens}
    image = torch.zeros((1, 3, vlm.d_model))
    assert model.loss(batch).shape == ()
    assert model.loss(dict(batch, media=image)).shape == ()
    for media in (None, image):
        assert model.forward(tokens, media).shape == (1, 4, vlm.vocab)
    wcfg = get_config("whisper-medium").reduced()
    m = build_model(wcfg, device="cpu")
    for fn, arg in ((m.forward, tokens), (m.loss, batch)):
        with pytest.raises(ValueError, match="takes media"):
            fn(arg)
    frames = torch.zeros((1, wcfg.n_audio_frames, wcfg.d_model))
    assert m.loss(dict(batch, media=frames)).shape == ()
    assert m.forward(tokens, frames).shape == (1, 4, wcfg.vocab)
    for arch in ("mamba2-130m", "zamba2-2.7b", "stablelm-1.6b",
                 "granite-moe-3b-a800m"):
        m = build_model(get_config(arch).reduced(), device="cpu")
        assert m.loss(batch).shape == ()
        assert m.forward(tokens).shape == (1, 4, m.cfg.vocab)
    assert len(m.loss_with_stats(batch)[1]) == m.cfg.n_layers
    # the dense class takes the dense and vlm families only
    with pytest.raises(NotImplementedError, match="not ported yet"):
        DecoderLM(get_config("granite-moe-3b-a800m").reduced(), device="cpu")


def test_media_requests_are_served_where_taken_and_ignored_elsewhere():
    """Media requests are served for both families that take them, the
    encoder-decoder and (now) the VLM; a request with media to a model
    that takes none (stablelm) is served as without them, as the JAX
    engine's models ignore them."""
    res = _run(
        "import numpy as np\n"
        "from repro_torch.data import RequestQueue\n"
        "from repro_torch.models import media_spec, needs_media\n"
        "from repro_torch.serve import Engine, EngineConfig\n"
        "eng = Engine.from_config(EngineConfig(max_seq=32, n_slots=2, "
        "arch='stablelm-1.6b', device='cpu'))\n"
        "assert not needs_media(eng.model.cfg)\n"
        "outs = []\n"
        "for media in (np.zeros((2, 3), np.float32), None):\n"
        "    q = RequestQueue()\n"
        "    q.submit(np.arange(4), 4, media=media)\n"
        "    outs.append(eng.serve(q)[0])\n"
        "    eng.reset()\n"
        "assert np.array_equal(*outs) and len(outs[0]) == 4\n"
        "eng = Engine.from_config(EngineConfig(max_seq=32, n_slots=2, "
        "device='cpu', arch='llama-3.2-vision-90b'))\n"
        "assert needs_media(eng.model.cfg) and eng.layout == 'lanes'\n"
        "q = RequestQueue()\n"
        "q.submit(np.arange(4), 4, media=np.ones(media_spec(eng.model.cfg, "
        "1)[1:], np.float32))\n"
        "assert len(eng.serve(q)[0]) == 4\n"
        "print('served')\n")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("served")


def test_launcher_downgrades_the_write_mode_on_lanes():
    """A sliding-window arch serves from the direct-only lanes layout: the
    CLI downgrades --write-mode as the JAX launcher does, and serves."""
    res = _run("from repro_torch.launch.serve import main\n"
               "main(['--arch', 'h2o-danube-3-4b', '--device', 'cpu', "
               "'--batched', '--requests', '3', '--slots', '2', "
               "'--prompt-len', '40', '--gen-len', '6', '--max-seq', '64', "
               "'--segment-len', '4', '--write-mode', 'staged'])\n")
    assert res.returncode == 0, res.stderr
    assert "downgrading --write-mode staged -> direct" in res.stdout
    assert "[lanes, reference, cpu] served 3 requests / 18 tokens" \
        in res.stdout


def test_new_modules_import_no_jax_when_loaded():
    """The key chain, the sampler, the traffic stack, the simulator and the
    MoE family load without JAX or the JAX package, and ``chip_smoke.py``
    imports neither."""
    res = _run(
        "import sys\n"
        "import repro_torch.models.prng, repro_torch.models.sampling\n"
        "import repro_torch.serve.traffic as T\n"
        "import repro_torch.distributed as D\n"
        "assert D.ParallelConfig and D.ShardedTensor\n"
        "import repro_torch.serve.traffic.workload, "
        "repro_torch.serve.traffic.harness\n"
        "import repro_torch.core.simulator as S, repro_torch.models.moe_lm\n"
        "import repro_torch.configs.paper_urdma, repro_torch.kernels.lru_scan\n"
        "assert S.RDMASimulator and S.sweep_point\n"
        "assert T.run_loadtest and T.PreemptAdmission\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{BANNED!r})\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
    for rel in ("models/prng.py", "serve/traffic/workload.py",
                "serve/traffic/harness.py", "serve/traffic/sched.py",
                "distributed/__init__.py", "distributed/sharding.py",
                "core/simulator.py", "configs/paper_urdma.py",
                "configs/granite_moe_3b_a800m.py",
                "configs/qwen3_moe_235b_a22b.py", "models/moe.py",
                "models/moe_lm.py", "kernels/lru_scan.py"):
        assert not _imported_roots(os.path.join(PKG, rel)) & set(BANNED)


def test_launcher_samples_on_cpu_when_asked():
    """``--temperature`` / ``--top-k`` / ``--top-p`` / ``--seed`` reach the
    requests' SamplingParams: a sampled run serves, and the same seed gives
    the same tokens."""
    code = ("from repro_torch.launch.serve import main\n"
            "main(['--arch', 'stablelm-1.6b', '--device', 'cpu', "
            "'--batched', '--requests', '3', '--slots', '2', "
            "'--prompt-len', '8', '--gen-len', '5', '--max-seq', '32', "
            "'--segment-len', '4', '--page-size', '4', '--temperature', "
            "'0.8', '--top-k', '20', '--top-p', '0.9', '--seed', '3'])\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert "served 3 requests / 15 tokens" in res.stdout


def test_training_modules_import_no_jax_when_loaded():
    """The optimizer, the trainer, the checkpoint writer, the training
    pipeline, the layout table and the train launcher load without JAX or
    the JAX package."""
    res = _run(
        "import sys\n"
        "import repro_torch.optim, repro_torch.train, repro_torch.checkpoint\n"
        "import repro_torch.launch.train, repro_torch.models.layout\n"
        "from repro_torch.data import Pipeline, SyntheticSource, MemmapSource\n"
        "from repro_torch.kernels import FlashAttentionFunction, staged_drain\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{BANNED!r})\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
    for rel in ("optim/adamw.py", "train/trainer.py", "launch/train.py",
                "models/layout.py", "checkpoint/checkpoint.py",
                "data/pipeline.py"):
        assert not _imported_roots(os.path.join(PKG, rel)) & set(BANNED)


def test_train_launcher_runs_on_cpu_and_refuses_otherwise(monkeypatch):
    """``python -m repro_torch.launch.train`` trains on the CPU when asked
    (a second run resumes from the first's checkpoint) and raises without a
    GPU by default. With more than one visible device it takes the JAX
    launcher's multi-device branch: stablelm-1.6b trains on the production
    mesh (here ``make_production_mesh`` gives a (2, 2) mesh of four
    virtual CPU devices) to the one-device run's loss (fp32, within 1e-5
    relative); too few devices for the mesh raise its ``ValueError``; the
    SSM family (mamba2-130m) takes the mesh branch too, to its one-device
    run's loss."""
    import tempfile

    from repro_torch.launch.train import main
    with tempfile.TemporaryDirectory() as d:
        args = ("['--arch', 'granite-moe-3b-a800m', '--device', 'cpu', "
                "'--seq', '16', '--batch', '4', '--microbatches', '2', "
                f"'--dispatch-mode', 'adaptive', '--checkpoint-dir', {d!r}, "
                "'--steps', ")
        res = _run("from repro_torch.launch.train import main\n"
                   f"main({args}'4'])\n"
                   f"main({args}'6'])\n")
        assert res.returncode == 0, res.stderr
        first, second = res.stdout.strip().splitlines()
        assert "'steps': 4" in first and "'steps': 2" in second
        assert "resuming from checkpoint step 4" in res.stderr
        assert sorted(os.listdir(d))[-1] == "step_000000006"
    with pytest.raises(RuntimeError, match="is_available"):
        main(["--arch", "stablelm-1.6b", "--steps", "1"])
    from repro_torch.distributed import ParallelConfig
    from repro_torch.launch import train as launcher
    args = ["--arch", "stablelm-1.6b", "--device", "cpu", "--steps", "3",
            "--seq", "16", "--batch", "4", "--microbatches", "2"]
    monkeypatch.delenv("REPRO_TORCH_VIRTUAL_DEVICES", raising=False)
    one = main(args)
    monkeypatch.setenv("REPRO_TORCH_VIRTUAL_DEVICES", "4")
    with pytest.raises(ValueError, match="needs 256 devices"):
        main(args)
    meshes = []

    def mesh_2x2(**kw):
        meshes.append(ParallelConfig((2, 2), ("data", "model")).build_mesh(
            device=kw["device"]))
        return meshes[-1]
    monkeypatch.setattr(launcher, "make_production_mesh", mesh_2x2)
    sharded = main(args)
    assert len(meshes) == 1 and meshes[0].shape == {"data": 2, "model": 2}
    assert sharded["steps"] == one["steps"] == 3
    assert sharded["final_loss"] == pytest.approx(one["final_loss"],
                                                  rel=1e-5)
    # the SSM family takes the mesh branch too, the loss that of one device
    ssm = ["--arch", "mamba2-130m", "--device", "cpu", "--steps", "2",
           "--seq", "16", "--batch", "4", "--microbatches", "2"]
    on_mesh = main(ssm)
    assert len(meshes) == 2
    monkeypatch.delenv("REPRO_TORCH_VIRTUAL_DEVICES")
    assert on_mesh["final_loss"] == pytest.approx(main(ssm)["final_loss"],
                                                  rel=1e-5)


def test_adamw_decays_by_the_rank_of_the_jax_layout():
    """Known difference, pinned: the JAX package decays a leaf of
    ``ndim > 1``, and it stacks each block's norms into ``[L, D]`` leaves,
    so they are decayed and only ``ln_f`` is not. The port keeps a ``[D]``
    norm a layer and decides by the rank in the JAX layout (one more for a
    block's leaf): with zero gradients only the decay moves a parameter,
    and it moves every block norm and every matrix, never ``ln_f``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.layout import jax_ndim
    from repro_torch.optim import AdamW
    m = build_model(get_config("stablelm-1.6b").reduced(), device="cpu")
    params = dict(m.named_parameters())
    before = {k: v.detach().clone() for k, v in params.items()}
    opt = AdamW(lr=0.1, weight_decay=0.5)
    opt.update({k: torch.zeros_like(v) for k, v in params.items()},
               opt.init(params), params)
    moved = {k for k, v in params.items() if not torch.equal(v, before[k])
             and before[k].abs().sum() > 0}
    nonzero = {k for k in params if before[k].abs().sum() > 0}
    assert "blocks.0.ln1.scale" in moved and "blocks.1.ln2.scale" in moved
    assert "ln_f.scale" not in moved
    assert jax_ndim("blocks.0.ln1.scale", params["blocks.0.ln1.scale"].shape) \
        == 2
    assert jax_ndim("ln_f.scale", params["ln_f.scale"].shape) == 1
    assert moved == {k for k in nonzero if k != "ln_f.scale"}
