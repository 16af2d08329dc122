#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

Run ``python3 chip_smoke.py`` from the root of a checkout. It needs a CUDA
device and ``nvcc``; without a GPU it exits non-zero and prints no result.
Phases, each failing the run on any exception or mismatch:

  env      the card's name and power limit, torch / CUDA / nvcc versions
  build    builds the CUDA kernels from ``src/repro_torch/kernels/csrc``
  kernels  each kernel against its plain PyTorch version on the card, and
           their times at the shapes the engine phase gives them
  engine   stablelm-1.6b at full width (24 layers, bf16, random weights from
           a seed) serves 16 requests through ``Engine.from_config``; both
           kernels' launch counts must be non-zero
  parity   the same arch at 4 layers, fp32: direct / staged / adaptive and
           fused / reference give identical greedy token streams

Every kernel time in the ``kernels`` line (``ms``, ``plain_ms``,
``library_ms``) is device time: the sum of the kernels' own times in the
profiler's trace, warm, mean of 20 calls. The time between CUDA events around
one call (median of 30) stands beside it as ``*event_ms``; for calls shorter
than their own enqueue it measures the host. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False; this script "
             "runs on a GPU only")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import synthetic_requests  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import (flash_decode_paged,  # noqa: E402
                                 flash_decode_paged_ref, launch_counts,
                                 reset_launch_counts, staged_scatter,
                                 staged_scatter_layers, staged_scatter_ref)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import (Engine, EngineConfig,  # noqa: E402
                               SamplingParams)

DEV = torch.device("cuda")
# published peaks of one H100 SXM (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# the slice: what the engine phase runs
SLICE = dict(arch="stablelm-1.6b", reduced=False, max_seq=2048, n_slots=8,
             page_size=16, segment_len=16, ring_size=8, path="adaptive")
N_REQUESTS, PROMPT_LENS, NEW_TOKENS = 16, [128, 256, 384, 512], 64
ENGINE_RUNS = 3  # the timed serve is repeated so its spread is seen

# K2 tolerances against the plain version on the same inputs.
# fp32: the JAX package's own kernel-vs-oracle bound (sums in another order).
TOL_F32 = dict(atol=2e-6, rtol=1e-4)
# bf16: the plain version rounds q.k to bf16 before the softmax (its einsum
# returns bf16), the kernel keeps fp32 scores; both round p and the output
# to bf16. The result is a few bf16 ulps (2^-8 relative) apart. This bound
# suits the small cases, whose outputs are of order 1; at the slice's shape
# (a mean over ~1300 keys, outputs of order 0.05) ``check_k2_slice`` holds
# the kernel to an fp32 reference instead.
TOL_BF16 = dict(atol=8e-3, rtol=1.6e-2)
# at the slice's shape in bf16: the kernel's error against the fp32 reference
# on the same inputs may be at most this many times the plain version's
SLICE_ERR_FACTOR = 2.0


def say(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def time_ms(fn, warm=5, reps=30):
    """Median time of one call, CUDA events, warm."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, reps=20):
    """Mean device time of one call: the sum of the kernels' own times as the
    profiler's CUPTI trace gives them, host gaps left out."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for e in prof.key_averages():
        total_us += getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
    if total_us <= 0:
        raise RuntimeError("the profiler's trace shows no device time")
    return total_us / reps / 1e3


def timings(kernel, plain, library):
    """Device time of the three (``ms``, ``plain_ms``, ``library_ms``) and,
    under its own keys, the time between CUDA events around one call."""
    out = {}
    for key, fn in (("ms", kernel), ("plain_ms", plain),
                    ("library_ms", library)):
        out[key] = device_ms(fn)
        out[key.replace("ms", "event_ms")] = time_ms(fn)
    return out


# ---------------------------------------------------------------------------


def phase_env():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    nvcc = subprocess.run([kbuild.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    # fp32 matrix products in full fp32 (PyTorch's default, stated and set)
    torch.backends.cuda.matmul.allow_tf32 = False
    say("env", torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=nvcc.stdout.strip().splitlines()[-2].strip(),
        python=sys.version.split()[0],
        allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    return card


def phase_build():
    kbuild.load_library()
    info = kbuild.build_info()
    ptxas = [ln.strip() for ln in str(info["log"]).splitlines()
             if "registers" in ln or "spill" in ln.lower()]
    say("build", seconds=round(float(info["seconds"]), 2),
        built=info["built"], sources=info["sources"], ptxas=ptxas[:24])


# ---------------------------------------------------------------------------
# K1 staged_scatter
# ---------------------------------------------------------------------------


def _k1_case(gen, dtype, r, w, n, valid_kind, layers=0):
    lead = (layers,) if layers else ()
    # a pool with spare rows after row r, as the engine's sink block gives
    store = torch.randn(lead + (r + 16, w), generator=gen, device=DEV).to(dtype)
    dest = store[..., :r, :]
    staging = torch.randn(lead + (n, w), generator=gen, device=DEV).to(dtype)
    rows = torch.randperm(r + 8, generator=gen, device=DEV)[:n] - 4  # some out of range
    valid = {"none": torch.zeros(n, dtype=torch.bool, device=DEV),
             "all": torch.ones(n, dtype=torch.bool, device=DEV),
             "mixed": torch.rand(n, generator=gen, device=DEV) > 0.4}[valid_kind]
    if layers:
        want = torch.stack([staged_scatter_ref(dest[l], staging[l], rows, valid)
                            for l in range(layers)])
        got = staged_scatter_layers(dest, staging, rows, valid)
    else:
        want = staged_scatter_ref(dest, staging, rows, valid)
        got = staged_scatter(dest, staging, rows, valid)
    torch.cuda.synchronize()
    assert got.data_ptr() == dest.data_ptr(), "staged_scatter is in place"
    if not torch.equal(got, want):
        raise AssertionError(
            f"staged_scatter mismatch: {dtype} r={r} w={w} n={n} "
            f"{valid_kind} layers={layers}")
    return float((got.float() - want.float()).abs().max())


def check_k1(gen):
    err, cases = 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        for kind in ("none", "all", "mixed"):
            for (r, w, n) in ((64, 256, 16), (40, 24, 9), (33, 7, 12)):
                err = max(err, _k1_case(gen, dtype, r, w, n, kind))
                err = max(err, _k1_case(gen, dtype, r, w, n, kind, layers=3))
                cases += 2
    # the slice's shape, one layer count as the engine drains it
    err = max(err, _k1_case(gen, torch.bfloat16, 16384, 2048, 64, "mixed",
                            layers=24))
    return err, cases + 1


def time_k1(gen):
    l, r, w, n = 24, 16384, 2048, 64
    store = torch.zeros((l, r + 16, w), dtype=torch.bfloat16, device=DEV)
    dest = store[:, :r]
    staging = torch.randn((l, n, w), generator=gen, device=DEV).to(torch.bfloat16)
    rows = torch.randperm(r, generator=gen, device=DEV)[:n]
    valid = torch.ones(n, dtype=torch.bool, device=DEV)
    none = torch.zeros(n, dtype=torch.bool, device=DEV)
    def plain():
        for i in range(l):
            staged_scatter_ref(dest[i], staging[i], rows, valid, inplace=True)

    t = timings(lambda: staged_scatter_layers(dest, staging, rows, valid),
                plain, lambda: dest.index_copy_(1, rows, staging))
    empty = lambda: staged_scatter_layers(dest, staging, rows, none)  # noqa: E731
    ms_empty = device_ms(empty)
    n_valid = int(valid.sum())
    nbytes = 2 * n_valid * w * 2 * l + n * 5
    return dict(**t,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                ms_no_valid_rows=ms_empty,
                shape=f"dest[{l},{r},{w}] staging[{l},{n},{w}] bf16, "
                      f"{n_valid} valid rows")


# ---------------------------------------------------------------------------
# K2 flash_decode_paged
# ---------------------------------------------------------------------------


def _k2_inputs(gen, dtype, b, c, hq, hkv, d, nb, ps, p, r, ring_kind="partial",
               dead_slot=False, masked_row=False):
    def rn(*shape):
        return torch.randn(shape, generator=gen, device=DEV).to(dtype)

    q, pk, pv = rn(b, c, hq, d), rn(nb, ps, hkv, d), rn(nb, ps, hkv, d)
    blocks = torch.randint(0, nb, (b, p), generator=gen, device=DEV,
                           dtype=torch.int32)
    view_ok = torch.rand((b, c, p * ps), generator=gen, device=DEV) > 0.35
    ring = (None, None, None)
    if r:
        ring_ok = {
            "empty": torch.zeros((b, r), dtype=torch.bool, device=DEV),
            "partial": (torch.arange(r, device=DEV)[None] < r // 2).expand(b, r).contiguous(),
            "full": torch.ones((b, r), dtype=torch.bool, device=DEV),
        }[ring_kind]
        ring = (rn(b, r, hkv, d), rn(b, r, hkv, d), ring_ok)
    if dead_slot:  # a retired slot: clamped page table, nothing valid
        blocks[0] = 0
        view_ok[0] = False
        if r:
            ring[2][0] = False
    if masked_row:  # one query column with every source masked
        view_ok[-1, -1] = False
        if r:
            ring[2][-1] = False
    return (q, pk, pv, blocks, view_ok) + ring


def check_k2(gen):
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = 0
    shapes = []  # b, c, hq, hkv, d, nb, ps, p, r
    for d in (16, 64):
        for c in (1, 8):
            for (hq, hkv) in ((4, 4), (8, 2)):
                shapes.append((3, c, hq, hkv, d, 12, 4, 5, 6))
    shapes += [(2, 1, 8, 1, 128, 6, 8, 3, 4),     # MQA, D=128
               (2, 3, 6, 3, 32, 9, 2, 6, 0),      # odd sizes, no ring
               (2, 1, 4, 4, 64, 40, 16, 20, 8)]   # several tiles of keys
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        for shp in shapes:
            r = shp[-1]
            kinds = ("empty", "partial", "full") if r else ("none",)
            for kind in kinds:
                for dead, masked in ((False, False), (True, True)):
                    args = _k2_inputs(gen, dtype, *shp, ring_kind=kind,
                                      dead_slot=dead, masked_row=masked)
                    got = flash_decode_paged(*args)
                    want = flash_decode_paged_ref(*args)
                    torch.cuda.synchronize()
                    if not torch.isfinite(got.float()).all():
                        raise AssertionError(f"non-finite output {shp} {kind}")
                    torch.testing.assert_close(
                        got.float(), want.float(), **tol,
                        msg=lambda m: f"flash_decode_paged {dtype} {shp} "
                                      f"{kind} dead={dead}: {m}")
                    errs[dtype] = max(errs[dtype], float(
                        (got.float() - want.float()).abs().max()))
                    cases += 1
    return errs, cases


def _k2_slice_inputs(gen, c):
    b, hq, hkv, d, nb, ps, p, r = 8, 32, 32, 64, 1024, 16, 128, 8
    dt = torch.bfloat16
    pk = torch.randn((nb + 1, ps, hkv, d), generator=gen, device=DEV).to(dt)
    pv = torch.randn((nb + 1, ps, hkv, d), generator=gen, device=DEV).to(dt)
    q = torch.randn((b, c, hq, d), generator=gen, device=DEV).to(dt)
    blocks = torch.randperm(nb, generator=gen, device=DEV).view(b, p).to(torch.int32)
    pos = torch.randint(600, 2040, (b,), generator=gen, device=DEV)
    view_ok = (torch.arange(p * ps, device=DEV)[None, None, :]
               <= (pos[:, None, None] - (c - 1)
                   + torch.arange(c, device=DEV)[None, :, None]))
    view_ok = view_ok.contiguous()
    rk = torch.randn((b, r, hkv, d), generator=gen, device=DEV).to(dt)
    rv = torch.randn((b, r, hkv, d), generator=gen, device=DEV).to(dt)
    rok = (torch.arange(r, device=DEV)[None] < 5).expand(b, r).contiguous()
    return q, pk, pv, blocks, view_ok, rk, rv, rok


def _as_f32(args):
    return tuple(t.float() if t is not None and t.is_floating_point() else t
                 for t in args)


def check_k2_slice(gen, c):
    """The kernel at the slice's shape. In fp32 it must meet the plain version
    within TOL_F32, which a dropped key or ring lane breaks. In bf16 both are
    held to the plain version run in fp32 on the same (upcast) inputs: the
    kernel may err at most SLICE_ERR_FACTOR times as far as the plain bf16
    version does."""
    args = _k2_slice_inputs(gen, c)
    args32 = _as_f32(args)
    ref32 = flash_decode_paged_ref(*args32)
    got32 = flash_decode_paged(*args32)
    torch.testing.assert_close(
        got32, ref32, **TOL_F32,
        msg=lambda m: f"flash_decode_paged fp32, slice shape, C={c}: {m}")
    got, plain = flash_decode_paged(*args), flash_decode_paged_ref(*args)
    torch.cuda.synchronize()
    err = float((got.float() - ref32).abs().max())
    err_plain = float((plain.float() - ref32).abs().max())
    if not err <= SLICE_ERR_FACTOR * err_plain:
        raise AssertionError(
            f"flash_decode_paged bf16, slice shape, C={c}: error {err} "
            f"against the fp32 reference, the plain version's is {err_plain}")
    return dict(c=c, err_f32=float((got32 - ref32).abs().max()),
                err_bf16_vs_f32_ref=err, plain_err_bf16_vs_f32_ref=err_plain,
                err_bf16_vs_plain=float((got.float() - plain.float()).abs().max()),
                out_rms=float(ref32.square().mean().sqrt()))


def time_k2(gen):
    args = _k2_slice_inputs(gen, 1)
    q, pk, pv, blocks, view_ok, rk, rv, rok = args
    b, c, hq, d = q.shape
    ps, hkv = pk.shape[1], pk.shape[2]
    p, r = blocks.shape[1], rk.shape[1]

    def library():
        # yardstick only: gathered view + one fused PyTorch attention call
        rows = (blocks.long()[:, :, None] * ps
                + torch.arange(ps, device=DEV)[None, None]).reshape(b, -1)
        k = torch.cat([pk.reshape(-1, hkv, d)[rows], rk], 1).transpose(1, 2)
        v = torch.cat([pv.reshape(-1, hkv, d)[rows], rv], 1).transpose(1, 2)
        mask = torch.cat([view_ok, rok[:, None, :].expand(b, c, r)], 2)
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k, v, attn_mask=mask[:, None])
    t = timings(lambda: flash_decode_paged(*args),
                lambda: flash_decode_paged_ref(*args), library)
    es = q.element_size()
    # The work depends on the data: a masked key adds exactly 0 to a row with
    # one live key, so the function needs the K and V rows that some query
    # column of their slot sees, and no other. These inputs have no row with
    # every key masked.
    assert bool(view_ok.any(2).all()), "a slice row has no live key"
    live_keys = int(view_ok.any(1).sum()) + int(rok.sum())
    all_keys = b * (p * ps + r)
    small = (2 * q.numel() * es                       # q in, out
             + blocks.numel() * 4 + view_ok.numel() + rok.numel())
    nbytes = live_keys * hkv * d * 2 * es + small     # live K and V rows
    flops = 4 * c * hq * live_keys * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    return dict(**t,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                live_keys=live_keys, all_keys=all_keys,
                # what the kernel as written reads (every view row and ring
                # lane, live or not, once): a note on the design, not the bound
                all_rows_ms=(all_keys * hkv * d * 2 * es + small)
                / HBM_BYTES_PER_S * 1e3,
                shape=f"q[{b},{c},{hq},{d}] pages[{pk.shape[0]},{ps},{hkv},{d}] "
                      f"blocks[{b},{p}] ring[{b},{r},{hkv},{d}] bf16")


def phase_kernels():
    gen = torch.Generator(device=DEV).manual_seed(0)
    k1_err, k1_cases = check_k1(gen)
    k2_errs, k2_cases = check_k2(gen)
    k2_slice = [check_k2_slice(gen, c) for c in (1, 8)]
    k1_t, k2_t = time_k1(gen), time_k2(gen)
    say("kernel_checks", staged_scatter_cases=k1_cases,
        staged_scatter_exact=True, flash_decode_paged_cases=k2_cases,
        flash_decode_paged_max_abs_err_f32=k2_errs[torch.float32],
        flash_decode_paged_max_abs_err_bf16=k2_errs[torch.bfloat16],
        tol_f32=TOL_F32, tol_bf16=TOL_BF16,
        staged_scatter_ms_no_valid_rows=k1_t.pop("ms_no_valid_rows"),
        staged_scatter_shape=k1_t.pop("shape"),
        flash_decode_paged_shape=k2_t.pop("shape"),
        flash_decode_paged_live_keys=k2_t.pop("live_keys"),
        flash_decode_paged_all_keys=k2_t.pop("all_keys"),
        flash_decode_paged_all_rows_ms=k2_t.pop("all_rows_ms"),
        flash_decode_paged_slice=k2_slice,
        slice_err_factor=SLICE_ERR_FACTOR)
    return [
        dict(name="staged_scatter", route="cuda",
             source="src/repro_torch/kernels/csrc/staged_scatter.cu",
             replaces="src/repro/kernels/staged_scatter.py:44",
             launches=None, max_abs_err=k1_err, **k1_t),
        dict(name="flash_decode_paged", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_decode_paged.cu",
             replaces="src/repro/kernels/flash_decode.py:135",
             launches=None, max_abs_err=max(k2_errs.values()), **k2_t),
    ]


# ---------------------------------------------------------------------------


def phase_engine(kernels):
    cfg = get_config(SLICE["arch"])
    t0 = time.perf_counter()
    eng = Engine.from_config(EngineConfig(**SLICE))
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    # warm-up, not counted: one short request per prompt length, so the
    # timed run below does not pay cuBLAS's first-call set-up
    t0 = time.perf_counter()
    eng.serve(synthetic_requests(len(PROMPT_LENS), PROMPT_LENS, cfg.vocab, 2,
                                 params=SamplingParams(max_tokens=2)))
    eng.reset()
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    sp = SamplingParams(max_tokens=NEW_TOKENS)

    def timed_serve():
        queue = synthetic_requests(N_REQUESTS, PROMPT_LENS, cfg.vocab,
                                   NEW_TOKENS, params=sp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.serve(queue)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    reset_launch_counts()           # counts = 0 just before the main path
    torch.cuda.reset_peak_memory_stats()
    outputs, dt = timed_serve()
    counts = launch_counts()        # read just after
    n_toks = sum(len(t) for t in outputs.values())
    stats = dict(eng.stats)
    comps = eng.completions()
    peak = torch.cuda.max_memory_allocated()
    # the same run again, for the spread of the host clock; greedy streams
    # must repeat exactly
    seconds = [dt]
    for _ in range(ENGINE_RUNS - 1):
        eng.reset()
        again, dt_i = timed_serve()
        seconds.append(dt_i)
        for rid, toks in outputs.items():
            assert (again[rid] == toks).all(), f"request {rid} did not repeat"
    say("engine", config=SLICE, n_layers=cfg.n_layers, dtype=cfg.dtype,
        requests=len(outputs), tokens=n_toks, seconds=seconds,
        tok_per_s=[n_toks / x for x in seconds], model_build_seconds=t_build,
        warm_up_seconds=t_warm,
        attention=eng.attention, stats=stats, launches=counts,
        peak_mem_gb=peak / 1e9)
    assert eng.attention == "fused", eng.attention
    assert len(outputs) == N_REQUESTS
    for rid, toks in outputs.items():
        assert toks.shape == (NEW_TOKENS,), (rid, toks.shape)
        assert ((toks >= 0) & (toks < cfg.vocab)).all(), rid
        pc = comps[rid].path_counts
        assert pc["direct"] + pc["staged"] == NEW_TOKENS - 1, pc
    assert stats["admitted"] == stats["retired"] == N_REQUESTS, stats
    assert stats["staged_writes"] > 0 and stats["drains"] > 0, stats
    for k in kernels:
        k["launches"] = counts[k["name"]]
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} was never launched by the "
                                 f"engine: {counts}")
    engine_profile(eng, cfg)
    del eng
    torch.cuda.empty_cache()


def engine_profile(eng, cfg):
    """Where one decode segment's time goes: 8 live slots, three segments
    timed on the host clock (the median is used), the next one under the
    profiler (device time by kernel name, and the device's busy share of the
    timed segment). The requests are long enough to stay live throughout."""
    from torch.profiler import ProfilerActivity, profile
    eng.reset()
    sch = eng.scheduler
    n_new = 6 * SLICE["segment_len"]    # 5 segments run below
    sch.admit(synthetic_requests(
        SLICE["n_slots"], PROMPT_LENS, cfg.vocab, n_new,
        params=SamplingParams(max_tokens=n_new)))
    sch.run_segment()               # warm
    torch.cuda.synchronize()
    seg = []
    for _ in range(3):
        t0 = time.perf_counter()
        sch.run_segment()
        torch.cuda.synchronize()
        seg.append((time.perf_counter() - t0) * 1e3)
    seg_ms = sorted(seg)[1]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sch.run_segment()
        torch.cuda.synchronize()
    steps = SLICE["segment_len"]
    rows = sorted(
        ((getattr(e, "self_device_time_total",
                  getattr(e, "self_cuda_time_total", 0.0)), e.count, e.key)
         for e in prof.key_averages()), reverse=True)
    dev_ms = sum(r[0] for r in rows) / 1e3
    say("engine_profile", slots=SLICE["n_slots"], steps=steps,
        segment_ms=seg, step_ms=seg_ms / steps,
        device_ms_per_step=dev_ms / steps,
        device_busy_share=dev_ms / seg_ms if dev_ms else None,
        launches_per_step=sum(r[1] for r in rows) / steps,
        top=[dict(kernel=k[:64], ms_per_step=us / 1e3 / steps,
                  calls_per_step=n / steps) for us, n, k in rows[:8]])


def phase_parity():
    """Smaller depth, full width, fp32: the write paths and the two read
    implementations must emit identical greedy token streams."""
    cfg = dataclasses.replace(get_config(SLICE["arch"]), n_layers=4,
                              dtype="float32")
    model = build_model(cfg, device=DEV).init(1)
    shape = dict(max_seq=512, n_slots=4, page_size=16, segment_len=8,
                 ring_size=4)
    plens, new = [128, 200, 256], 24

    def run(path, attention):
        eng = Engine.from_config(EngineConfig(
            path=path, attention=attention, **shape), model)
        out = eng.serve(synthetic_requests(6, plens, cfg.vocab, new))
        stats = dict(eng.stats)
        del eng
        torch.cuda.empty_cache()
        return out, stats

    base, base_stats = run("direct", "fused")
    report = {}
    for path, attention in (("staged", "fused"), ("adaptive", "fused"),
                            ("adaptive", "reference"), ("staged", "reference")):
        out, stats = run(path, attention)
        for rid in base:
            if not (out[rid] == base[rid]).all():
                raise AssertionError(
                    f"token streams differ: {path}/{attention} vs "
                    f"direct/fused, request {rid}: {out[rid]} vs {base[rid]}")
        report[f"{path}/{attention}"] = {
            k: stats[k] for k in ("direct_writes", "staged_writes", "drains")}
    say("parity", n_layers=cfg.n_layers, dtype=cfg.dtype, requests=len(base),
        tokens=sum(len(t) for t in base.values()), identical_streams=True,
        runs=report)


def main():
    t0 = time.perf_counter()
    card = phase_env()
    phase_build()
    kernels = phase_kernels()
    phase_engine(kernels)
    phase_parity()
    say("done", seconds=round(time.perf_counter() - t0, 1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
