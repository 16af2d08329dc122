#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

Run ``python3 chip_smoke.py`` from the root of a checkout. It needs a CUDA
device and ``nvcc``; without a GPU it exits non-zero and prints no result.
Phases, each failing the run on any exception or mismatch:

  env      the card's name and power limit, torch / CUDA / nvcc versions
  build    builds the CUDA kernels from ``src/repro_torch/kernels/csrc``
  kernels  each kernel against its plain PyTorch version on the card, and
           their times at the shapes the engine phases give them
  engine   stablelm-1.6b at full width (24 layers, bf16, random weights from
           a seed) serves 16 requests through ``Engine.from_config`` on the
           paged layout; the launch counts of staged_scatter,
           flash_decode_paged and flash_attention must be non-zero
  lanes    h2o-danube-3-4b at full width (24 layers, bf16, sliding window
           4096) serves 12 requests with prompts up to 4608 tokens on the
           lanes layout; flash_attention's and flash_decode's launch counts
           must be non-zero
  parity   stablelm-1.6b at 4 layers, fp32: direct / staged / adaptive,
           fused / reference and paged / lanes give identical greedy token
           streams; h2o-danube-3-4b at 2 layers (window cut to 128), fp32:
           the engine on the card and the same weights on the CPU (the
           plain versions) give identical greedy token streams
  write_engine  the flat RemoteWriteEngine at the paper's section 4 size:
           4 GiB of registered fp32 memory (2^20 regions of 4 KB, four uMTT
           registrations), 64 batches of 4096 writes of 16-256 B to
           Zipf(0.5) regions, through four decision planes (always offload,
           always unload, frequency and hysteresis over a count-min sketch);
           the four memories must be bit-identical and equal a sequential
           last-write-wins oracle, nothing rejected, both sketch engines
           must unload a share strictly between 0 and 1 and launch
           cms_update and cms_query once per batch; the stream, made again
           from its seed, must be the same, and the card must draw the
           regions the CPU draws from the same uniforms
  write_parity  the same four engines on the card and on the CPU (the
           plain versions) at 2^12 regions, with 1 write in 64 carrying a
           wrong stag: memory, telemetry and ring state identical

Every kernel time in the ``kernels`` line (``ms``, ``plain_ms``,
``library_ms``) is device time: the sum of the kernels' own times in the
profiler's trace, warm, mean of 20 calls. A trace that holds no device event
is taken again, up to three times in all; where none does, the time is that
between CUDA events around the 20 calls, and the ``done`` line names it under
``traces_without_device_time``. The time between CUDA events around one call
(median of 30) stands beside it as ``*event_ms``; for calls shorter than
their own enqueue it measures the host. The last line is
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
from repro_torch.core import (AlwaysOffload, AlwaysUnload,  # noqa: E402
                              CMSMonitor, DecisionModule, FrequencyPolicy,
                              HysteresisPolicy, RemoteWriteEngine, make_umtt,
                              make_write_batch, register, zipf_regions)
from repro_torch.kernels.cms import cms_hash  # noqa: E402
from repro_torch.data import synthetic_requests  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import (cms_query, cms_query_ref,  # noqa: E402
                                 cms_update, cms_update_ref, flash_attention,
                                 flash_attention_ref, flash_decode,
                                 flash_decode_paged, flash_decode_paged_ref,
                                 flash_decode_ref, launch_counts,
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
# the lanes slice: the sliding-window model; max_seq 6144 makes the cache
# 4096 = the window, and 4608-token prompts exceed it, so prefill masks with
# the window, the cache keeps a rolled ring and decode wraps it
LANES = dict(arch="h2o-danube-3-4b", reduced=False, max_seq=6144, n_slots=8,
             segment_len=16, path="direct")
LANES_REQUESTS, LANES_PROMPTS, LANES_NEW = 12, [512, 2048, 4608], 64
LANES_GROUP = 2  # 4608-token prompts per prefill call (the first admission's)

# the flat write engine (section 4 of the paper): 2^20 regions of 4 KB
WRITE = dict(log2_regions=20, region_elems=1024, batches=64, batch=4096,
             width=64, ring=8192, cms=(4, 16), decay_every=65536,
             threshold=4, lo=2, hi=8, umtt=64, registrations=4, bad_every=0)
# the same engines, small, on the card and on the CPU, with bad stags
WRITE_PARITY = dict(log2_regions=12, region_elems=256, batches=32, batch=256,
                    width=64, ring=512, cms=(4, 10), decay_every=2048,
                    threshold=4, lo=2, hi=8, umtt=64, registrations=4,
                    bad_every=64)
WRITE_ENGINES = ("direct", "staged", "adaptive-cms", "hysteresis-cms")
# the sketch kernels are timed at the JAX default sketch and at the write
# engine's, at one engine batch and at 2^20 ids
CMS_TIMED = [(4, 12, 4096), (4, 16, 4096), (4, 12, 1 << 20), (4, 16, 1 << 20)]

# Tolerances against the plain version on the same inputs.
# fp32: the JAX package's own kernel-vs-oracle bound (sums in another order).
TOL_F32 = dict(atol=2e-6, rtol=1e-4)
# bf16: the plain version rounds q.k to bf16 before the softmax (its einsum
# returns bf16), the kernel keeps fp32 scores; both round p and the output
# to bf16. The result is a few bf16 ulps (2^-8 relative) apart. This bound
# suits K2's small cases, whose outputs are of order 1; at the slice's shape
# (a mean over ~1300 keys, outputs of order 0.05) ``check_k2_slice`` holds
# the kernel to an fp32 reference instead, and so does ``check_bf16`` for
# every bf16 case of K3 and K4.
TOL_BF16 = dict(atol=8e-3, rtol=1.6e-2)
# bf16: the kernel's error against the plain version run in fp32 on the same
# inputs may be at most this many times the plain bf16 version's
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


# Profiler traces that came back without a device event, by what was traced:
# CUPTI now and then delivers none for a short trace, so every trace is
# retried and a miss that lasts is reported in the ``done`` line.
TRACE_MISSES = []


def trace_rows(run, what, tries=3):
    """``(self device us, calls, kernel name)`` for every kernel that ``run``
    launches, from the profiler's CUPTI trace, largest first. A trace with no
    device time is taken again, up to ``tries`` times; then ``[]``."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        rows = sorted(
            ((getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0.0)), e.count, e.key)
             for e in prof.key_averages()), reverse=True)
        if sum(r[0] for r in rows) > 0:
            return rows
    TRACE_MISSES.append(what)
    return []


def device_ms(fn, what, reps=20):
    """Mean device time of one call: the sum of the kernels' own times as the
    profiler's CUPTI trace gives them, host gaps left out. Where no trace
    holds a device event, the time between CUDA events around ``reps`` calls
    in a row, over ``reps`` (host gaps in), and ``what`` is in
    ``TRACE_MISSES``."""
    fn()
    def run():
        for _ in range(reps):
            fn()
    rows = trace_rows(run, what)
    if rows:
        return sum(r[0] for r in rows) / reps / 1e3
    return time_ms(run, warm=1, reps=5) / reps


def timings(name, kernel, plain, library):
    """Device time of the three (``ms``, ``plain_ms``, ``library_ms``) and,
    under its own keys, the time between CUDA events around one call."""
    out = {}
    for key, fn in (("ms", kernel), ("plain_ms", plain),
                    ("library_ms", library)):
        out[key] = device_ms(fn, f"{name} {key}")
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

    t = timings("staged_scatter",
                lambda: staged_scatter_layers(dest, staging, rows, valid),
                plain, lambda: dest.index_copy_(1, rows, staging))
    empty = lambda: staged_scatter_layers(dest, staging, rows, none)  # noqa: E731
    ms_empty = device_ms(empty, "staged_scatter, no valid row")
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
    t = timings("flash_decode_paged", lambda: flash_decode_paged(*args),
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


# ---------------------------------------------------------------------------
# K3 flash_attention
# ---------------------------------------------------------------------------


def _k3_inputs(gen, dtype, b, hq, hkv, s, t, d, model_layout=True):
    """q [B,Hq,S,D], k/v [B,Hkv,T,D]; by default [B,S,H,D] tensors seen
    transposed, as the model passes them."""
    def rn(h, n):
        if model_layout:
            return torch.randn((b, n, h, d), generator=gen,
                               device=DEV).to(dtype).transpose(1, 2)
        return torch.randn((b, h, n, d), generator=gen, device=DEV).to(dtype)
    return rn(hq, s), rn(hkv, t), rn(hkv, t)


# b, hq, hkv, s, t, d, causal, window: head_dim 64 / 120 / 128, GQA group 1
# and 4, S = T and S < T, window 0 and < S, ragged S and T; the paged
# engine's prefill shapes (stablelm: 32 heads of 64, S = T = 384 and 512);
# a window that cuts 64-key tiles partway (4000 at S = T = 4608)
K3_CASES = [(1, 4, 4, 1, 1, 64, True, 0), (2, 4, 1, 37, 37, 120, True, 0),
            (1, 8, 2, 37, 1000, 128, True, 16),
            (1, 4, 4, 1000, 1000, 120, True, 300),
            (2, 8, 2, 128, 128, 64, False, 0),
            (1, 4, 1, 64, 200, 120, False, 50),
            (1, 4, 1, 300, 4608, 64, True, 4096),
            (1, 2, 2, 700, 700, 120, True, 0),
            (1, 4, 1, 4608, 4608, 120, True, 4096),
            (2, 32, 32, 512, 512, 64, True, 0),
            (2, 32, 32, 384, 384, 64, True, 0),
            (1, 4, 1, 4608, 4608, 120, True, 4000)]
# bf16 is held block by block: K3 by its query tile (64 rows of one head),
# so the rows past the window form blocks of their own; K4 row by row
K3_TILE, K4_ROWS = 64, 1


def _block_max(x, rows):
    """max |x| over each block of ``rows`` consecutive query rows of one
    (batch, head): ``[B,H,S,D]`` -> ``[B,H,ceil(S/rows)]``; a ``[B,H,D]``
    decode output counts as S = 1."""
    x = x.abs()
    if x.dim() == 3:
        x = x[:, :, None]
    pad = -x.shape[2] % rows
    x = F.pad(x, (0, 0, 0, pad))
    return x.reshape(x.shape[0], x.shape[1], -1, rows * x.shape[3]).amax(-1)


def held_bf16(name, case, got, plain, ref32, rows):
    """The bf16 rule. ``ref32`` is the plain version run in fp32 on the same
    (upcast) inputs. Over the whole tensor the kernel may err at most
    SLICE_ERR_FACTOR times as far from it as the plain bf16 version. Block by
    block (``_block_max``), the same, plus half a bf16 ulp of the block's
    largest value, the error of rounding an exact result to bf16, which both
    versions pay. (The plain version rounds q.k to bf16 before the softmax,
    the kernels keep fp32 scores, so a fixed tolerance against the plain bf16
    output does not fit every case.) Returns what the phase reports."""
    diff, diff_plain = got.float() - ref32, plain.float() - ref32
    err, err_plain = float(diff.abs().max()), float(diff_plain.abs().max())
    if not err <= SLICE_ERR_FACTOR * err_plain:
        raise AssertionError(
            f"{name} bf16 {case}: error {err} against the fp32 reference, "
            f"the plain version's is {err_plain}")
    blk, blk_plain = _block_max(diff, rows), _block_max(diff_plain, rows)
    limit = SLICE_ERR_FACTOR * blk_plain + 2.0 ** -8 * _block_max(ref32, rows)
    share = float((blk / limit.clamp(min=1e-30)).max())
    if not bool((blk <= limit).all()):
        i = int((blk - limit).argmax())
        raise AssertionError(
            f"{name} bf16 {case}: block {i} ({rows} rows each) errs "
            f"{float(blk.flatten()[i])}, its limit is "
            f"{float(limit.flatten()[i])} (the plain version's error there "
            f"is {float(blk_plain.flatten()[i])})")
    return dict(err=err, err_plain=err_plain, worst_block_share=share,
                err_vs_plain=float((got.float() - plain.float()).abs().max()))


def check_bf16(name, case, kernel, plain, args, rows):
    """``held_bf16`` on the kernel's and the plain version's outputs; returns
    the kernel's max abs difference from the plain bf16 version and the
    largest share of its block limit that any block used."""
    got, want = kernel(*args), plain(*args)
    ref32 = plain(*_as_f32(args))
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name} non-finite, bf16 {case}")
    h = held_bf16(name, case, got, want, ref32, rows)
    return h["err_vs_plain"], h["worst_block_share"]


def check_k3(gen):
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases, share = 0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for i, (b, hq, hkv, s, t, d, causal, w) in enumerate(K3_CASES):
            q, k, v = _k3_inputs(gen, dtype, b, hq, hkv, s, t, d,
                                 model_layout=i % 2 == 0)
            if dtype == torch.bfloat16:
                e, sh = check_bf16(
                    "flash_attention", K3_CASES[i],
                    lambda *a: flash_attention(*a, causal, w),
                    lambda *a: flash_attention_ref(*a, causal, w), (q, k, v),
                    K3_TILE)
                errs[dtype], share = max(errs[dtype], e), max(share, sh)
                cases += 1
                continue
            got = flash_attention(q, k, v, causal, w)
            want = flash_attention_ref(q, k, v, causal, w)
            torch.cuda.synchronize()
            torch.testing.assert_close(
                got, want, **TOL_F32,
                msg=lambda m: f"flash_attention fp32 {K3_CASES[i]}: {m}")
            errs[dtype] = max(errs[dtype], float((got - want).abs().max()))
            cases += 1
    return errs, cases, share


def _k3_slice_inputs(gen, dtype=torch.bfloat16):
    c = get_config(LANES["arch"])
    return _k3_inputs(gen, dtype, LANES_GROUP, c.n_heads, c.n_kv_heads,
                      max(LANES_PROMPTS), max(LANES_PROMPTS),
                      c.resolved_head_dim)


def check_k3_slice(gen):
    """At the lanes slice's prefill shape: fp32 within TOL_F32 of the plain
    version; bf16 by ``held_bf16``, block by block of 64 query rows."""
    window = get_config(LANES["arch"]).sliding_window
    args = _k3_slice_inputs(gen)
    args32 = tuple(x.float() for x in args)
    ref32 = flash_attention_ref(*args32, True, window)
    got32 = flash_attention(*args32, True, window)
    torch.testing.assert_close(
        got32, ref32, **TOL_F32,
        msg=lambda m: f"flash_attention fp32, slice shape: {m}")
    err_f32 = float((got32 - ref32).abs().max())
    del got32
    got = flash_attention(*args, True, window)
    plain = flash_attention_ref(*args, True, window)
    torch.cuda.synchronize()
    h = held_bf16("flash_attention", "slice shape", got, plain, ref32, K3_TILE)
    out_rms = float(ref32.square().mean().sqrt())
    del got, plain, ref32
    torch.cuda.empty_cache()
    return dict(err_f32=err_f32, err_bf16_vs_f32_ref=h["err"],
                plain_err_bf16_vs_f32_ref=h["err_plain"],
                worst_block_share=h["worst_block_share"], out_rms=out_rms)


def live_pairs(s, t, causal, window):
    """(query, key) pairs the mask lets through, counted per head."""
    qa = torch.arange(s, dtype=torch.int64) + (t - s)
    hi = qa if causal else torch.full_like(qa, t - 1)
    lo = (qa - window + 1).clamp(min=0) if window > 0 else torch.zeros_like(qa)
    return int((hi.clamp(max=t - 1) - lo + 1).clamp(min=0).sum())


def time_k3(gen):
    window = get_config(LANES["arch"]).sliding_window
    q, k, v = _k3_slice_inputs(gen)
    b, hq, s, d = q.shape
    t = k.shape[2]
    t_ = timings("flash_attention",
                 lambda: flash_attention(q, k, v, True, window),
                 lambda: flash_attention_ref(q, k, v, True, window),
                 # yardstick only: causal, no window (SDPA takes no window
                 # rule but an explicit mask, which would time its masked path)
                 lambda: F.scaled_dot_product_attention(
                     q, k, v, is_causal=True, enable_gqa=True))
    pairs = live_pairs(s, t, True, window)
    flops = 4 * d * hq * b * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    t_ops, t_bytes = flops / PEAK_FLOPS[q.dtype], nbytes / HBM_BYTES_PER_S
    return dict(**t_, bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                live_pairs_per_head=pairs,
                shape=f"q[{b},{hq},{s},{d}] k/v[{b},{k.shape[1]},{t},{d}] "
                      f"bf16 (strided views of [B,S,H,D]), causal, window "
                      f"{window}")


# ---------------------------------------------------------------------------
# K4 flash_decode
# ---------------------------------------------------------------------------


def _k4_inputs(gen, dtype, b, hq, hkv, t, d, special=False):
    def rn(*shape):
        return torch.randn(shape, generator=gen, device=DEV).to(dtype)

    q, k, v = rn(b, hq, d), rn(b, t, hkv, d), rn(b, t, hkv, d)
    mask = torch.rand((b, t), generator=gen, device=DEV) > 0.35
    if special:
        mask[0] = False             # no live key: the uniform mean
        if b > 1:
            mask[1] = False
            mask[1, t // 2] = True  # one live key
    return q, k, v, mask


K4_CASES = [(3, 4, 4, 1, 64), (2, 8, 2, 37, 120), (2, 4, 1, 1000, 128),
            (4, 32, 32, 700, 64), (8, 32, 8, 4096, 120), (2, 8, 8, 300, 16),
            (3, 6, 3, 129, 32)]


def check_k4(gen):
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases, share = 0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for shp in K4_CASES:
            for special in (False, True):
                args = _k4_inputs(gen, dtype, *shp, special=special)
                cases += 1
                if dtype == torch.bfloat16:
                    e, sh = check_bf16("flash_decode", (shp, special),
                                       flash_decode, flash_decode_ref, args,
                                       K4_ROWS)
                    errs[dtype], share = max(errs[dtype], e), max(share, sh)
                    continue
                got = flash_decode(*args)
                want = flash_decode_ref(*args)
                torch.cuda.synchronize()
                torch.testing.assert_close(
                    got, want, **TOL_F32,
                    msg=lambda m: f"flash_decode fp32 {shp} "
                                  f"special={special}: {m}")
                errs[dtype] = max(errs[dtype], float(
                    (got - want).abs().max()))
    return errs, cases, share


def _k4_slice_inputs(gen, all_live):
    """The lanes cache at the slice's shape: 8 slots x 4096 slots of 8 KV
    heads; every key live (every slot past the window), or slot i live up to
    a position drawn from 600-4095 as early in a request."""
    c = get_config(LANES["arch"])
    b, t = LANES["n_slots"], c.sliding_window
    q, k, v, _ = _k4_inputs(gen, torch.bfloat16, b, c.n_heads, c.n_kv_heads,
                            t, c.resolved_head_dim)
    if all_live:
        mask = torch.ones((b, t), dtype=torch.bool, device=DEV)
    else:
        pos = torch.randint(600, t, (b, 1), generator=gen, device=DEV)
        mask = torch.arange(t, device=DEV)[None] <= pos
    return q, k, v, mask


def check_k4_slice(gen, all_live):
    args = _k4_slice_inputs(gen, all_live)
    args32 = _as_f32(args)
    ref32 = flash_decode_ref(*args32)
    got32 = flash_decode(*args32)
    torch.testing.assert_close(
        got32, ref32, **TOL_F32,
        msg=lambda m: f"flash_decode fp32, slice shape: {m}")
    got, plain = flash_decode(*args), flash_decode_ref(*args)
    torch.cuda.synchronize()
    h = held_bf16("flash_decode", "slice shape", got, plain, ref32, K4_ROWS)
    return dict(all_live=all_live, err_f32=float((got32 - ref32).abs().max()),
                err_bf16_vs_f32_ref=h["err"],
                plain_err_bf16_vs_f32_ref=h["err_plain"],
                worst_block_share=h["worst_block_share"],
                out_rms=float(ref32.square().mean().sqrt()))


def time_k4(gen):
    q, k, v, mask = _k4_slice_inputs(gen, all_live=True)
    b, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]

    def library():
        # yardstick only: one fused PyTorch attention call over the lanes
        return F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask[:, None, None, :], enable_gqa=True)
    t_ = timings("flash_decode", lambda: flash_decode(q, k, v, mask),
                 lambda: flash_decode_ref(q, k, v, mask), library)
    es = q.element_size()
    n_live = int(mask.sum())      # the work depends on the data: live keys
    nbytes = n_live * hkv * d * 2 * es + 2 * q.numel() * es + mask.numel()
    flops = 4 * hq * n_live * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[q.dtype]
    return dict(**t_, bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                live_keys=n_live,
                shape=f"q[{b},{hq},{d}] k/v[{b},{t},{hkv},{d}] bf16, "
                      f"{n_live} live keys")


# ---------------------------------------------------------------------------
# K5 cms_update, K6 cms_query
# ---------------------------------------------------------------------------


def _cms_ids(gen, n, dtype=torch.int32):
    """n ids over the whole int32 range, negatives included."""
    return torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=gen,
                         device=DEV, dtype=torch.int64).to(dtype)


def _cms_case(counts, ids, mask, what):
    """K5 and K6 against their plain versions on the same inputs: exact."""
    want = cms_update_ref(counts, ids, mask)
    got = cms_update(counts.clone(), ids, mask)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"cms_update mismatch: {what}")
    est, est_want = cms_query(got, ids), cms_query_ref(want, ids)
    torch.cuda.synchronize()
    if est.dtype != torch.int32 or not torch.equal(est, est_want):
        raise AssertionError(f"cms_query mismatch: {what}")
    return 1


def check_cms(gen):
    """Depth 1-4, k in {0, 4, 6, 10, 12, 16}, n in {0, 1, 255, 256, 1000,
    4096, 2^20}, each masked and not; ids over the whole int32 range, int32
    and int64 alternating, both at one engine batch (4096); zero and non-zero
    starting counts. Then the write engines' own ids (int64, Zipf(0.5) over
    their regions, many duplicates) at their sketches and batches, 256 equal
    ids, distinct ids that share a bucket, and negative ids."""
    cases = 0
    for depth in (1, 2, 3, 4):
        for ki, k in enumerate((0, 4, 6, 10, 12, 16)):
            for ni, n in enumerate((0, 1, 255, 256, 1000, 4096, 1 << 20)):
                dts = ((torch.int32, torch.int64) if n == 4096 else
                       (torch.int64 if (ki + ni) % 2 else torch.int32,))
                start = (torch.randint(0, 5, (depth, 1 << k), generator=gen,
                                       device=DEV, dtype=torch.int32)
                         if (depth + ki) % 2 else
                         torch.zeros((depth, 1 << k), dtype=torch.int32,
                                     device=DEV))
                mask = torch.rand((n,), generator=gen, device=DEV) > 0.3
                for dt in dts:
                    ids = _cms_ids(gen, n, dt)
                    for m in (None, mask):
                        cases += _cms_case(start, ids, m,
                                           f"depth={depth} k={k} n={n} {dt} "
                                           f"masked={m is not None}")
    for shape in (WRITE, WRITE_PARITY):
        depth, k = shape["cms"]
        start = torch.randint(0, 5, (depth, 1 << k), generator=gen,
                              device=DEV, dtype=torch.int32)
        ids = zipf_regions(shape["batch"], 1 << shape["log2_regions"], 0.5,
                           generator=gen, device=DEV)
        mask = torch.rand(ids.shape, generator=gen, device=DEV) > 0.3
        for m in (None, mask):
            cases += _cms_case(start, ids, m,
                               f"Zipf(0.5) ids, depth={depth} k={k} "
                               f"n={ids.numel()} masked={m is not None}")
    same = torch.full((256,), 12345, dtype=torch.int32, device=DEV)
    zero = torch.zeros((4, 1 << 10), dtype=torch.int32, device=DEV)
    cases += _cms_case(zero, same, None, "256 equal ids")
    if int(cms_query(cms_update(zero.clone(), same), same[:1])[0]) != 256:
        raise AssertionError("cms: 256 equal ids do not count 256")
    h = cms_hash(torch.arange(2048), 0, 4)
    bucket = torch.nonzero(h == h[0]).flatten()[:8].to(DEV)
    one = torch.zeros((1, 16), dtype=torch.int32, device=DEV)
    cases += _cms_case(one, bucket, None, "8 ids in one bucket")
    if int(cms_update(one.clone(), bucket)[0, int(h[0])]) != 8:
        raise AssertionError("cms: 8 ids in one bucket do not stack")
    neg = torch.tensor([-5, -1, -2 ** 31, 7, -5], device=DEV)
    for dt in (torch.int32, torch.int64):
        cases += _cms_case(zero, neg.to(dt), None, f"negative ids {dt}")
    return cases


def _cms_flat(counts, ids):
    """Flat bucket index of every (row, id), for the library calls."""
    depth, width = counts.shape
    k = width.bit_length() - 1
    return torch.cat([r * width + cms_hash(ids, r, k) for r in range(depth)])


def _sector_bytes(flat):
    """Bytes of the distinct 32-byte sectors (8 int32 counters) that the flat
    bucket indices touch: what the counters must move from or to HBM."""
    return torch.unique(flat // 8).numel() * 32


def time_cms(gen):
    """K5 and K6 at the four sizes of ``CMS_TIMED``, int64 ids as the engine
    passes them, no mask (the engine's calls), uniform ids over 2^20
    regions. The library calls take precomputed bucket indices: the hash is
    excluded from them. The bounds count the ids once, the estimates once
    (K6) and, once each way, the counter sectors this run's ids touch."""
    rows = {"cms_update": [], "cms_query": []}
    for depth, k, n in CMS_TIMED:
        counts = torch.zeros((depth, 1 << k), dtype=torch.int32, device=DEV)
        ids = torch.randint(0, 1 << 20, (n,), generator=gen, device=DEV)
        flat = _cms_flat(counts, ids)
        ones = torch.ones_like(flat, dtype=torch.int32)
        cview = counts.view(-1)
        ctr = _sector_bytes(flat)
        shape = (f"counts[{depth},{1 << k}] int32, ids[{n}] int64, "
                 f"{ctr // 32} counter sectors touched")
        up = timings(f"cms_update {shape}", lambda: cms_update(counts, ids),
                     lambda: cms_update_ref(counts, ids, inplace=True),
                     lambda: cview.index_add_(0, flat, ones))
        up_bytes = n * ids.element_size() + 2 * ctr
        rows["cms_update"].append(dict(
            **up, bound_ms=up_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            shape=shape))
        q = timings(f"cms_query {shape}", lambda: cms_query(counts, ids),
                    lambda: cms_query_ref(counts, ids),
                    lambda: cview.take(flat).view(depth, n).amin(0))
        q_bytes = n * ids.element_size() + n * 4 + ctr
        rows["cms_query"].append(dict(
            **q, bound_ms=q_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            shape=shape))
    return rows


def phase_kernels():
    gen = torch.Generator(device=DEV).manual_seed(0)
    k1_err, k1_cases = check_k1(gen)
    k2_errs, k2_cases = check_k2(gen)
    k2_slice = [check_k2_slice(gen, c) for c in (1, 8)]
    k3_errs, k3_cases, k3_share = check_k3(gen)
    k3_slice = check_k3_slice(gen)
    k4_errs, k4_cases, k4_share = check_k4(gen)
    k4_slice = [check_k4_slice(gen, live) for live in (True, False)]
    cms_cases = check_cms(gen)
    k1_t, k2_t = time_k1(gen), time_k2(gen)
    k3_t, k4_t = time_k3(gen), time_k4(gen)
    cms_t = time_cms(gen)
    say("kernel_checks", staged_scatter_cases=k1_cases,
        staged_scatter_exact=True, flash_decode_paged_cases=k2_cases,
        flash_decode_paged_max_abs_err_f32=k2_errs[torch.float32],
        flash_decode_paged_max_abs_err_bf16=k2_errs[torch.bfloat16],
        flash_attention_cases=k3_cases,
        bf16_rule_k3_k4="error vs the fp32 plain version <= "
                        "slice_err_factor x the plain bf16 version's, over "
                        "the tensor and in each block (+ half a bf16 ulp of "
                        "the block's largest value there)",
        bf16_blocks=dict(flash_attention=f"{K3_TILE} query rows of a head",
                         flash_decode=f"{K4_ROWS} row"),
        flash_attention_max_abs_err_f32=k3_errs[torch.float32],
        flash_attention_max_abs_err_bf16=k3_errs[torch.bfloat16],
        flash_attention_bf16_worst_block_share=k3_share,
        flash_decode_cases=k4_cases,
        flash_decode_max_abs_err_f32=k4_errs[torch.float32],
        flash_decode_max_abs_err_bf16=k4_errs[torch.bfloat16],
        flash_decode_bf16_worst_block_share=k4_share,
        tol_f32=TOL_F32, tol_bf16=TOL_BF16,
        staged_scatter_ms_no_valid_rows=k1_t.pop("ms_no_valid_rows"),
        staged_scatter_shape=k1_t.pop("shape"),
        flash_decode_paged_shape=k2_t.pop("shape"),
        flash_decode_paged_live_keys=k2_t.pop("live_keys"),
        flash_decode_paged_all_keys=k2_t.pop("all_keys"),
        flash_decode_paged_all_rows_ms=k2_t.pop("all_rows_ms"),
        flash_decode_paged_slice=k2_slice,
        flash_attention_shape=k3_t.pop("shape"),
        flash_attention_live_pairs_per_head=k3_t.pop("live_pairs_per_head"),
        flash_attention_slice=k3_slice,
        flash_decode_shape=k4_t.pop("shape"),
        flash_decode_live_keys=k4_t.pop("live_keys"),
        flash_decode_slice=k4_slice,
        slice_err_factor=SLICE_ERR_FACTOR, cms_cases=cms_cases,
        cms_exact=True)
    # the kernels line: the write engine's sketch (depth 4, k 16) at one
    # engine batch; all four timed sizes under "sizes"
    cms_main = CMS_TIMED.index((4, 16, 4096))
    cms_rows = []
    for name, line in (("cms_update", 51), ("cms_query", 109)):
        cms_rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/cms.cu",
            replaces=f"src/repro/kernels/cms.py:{line}", launches=None,
            max_abs_err=0.0, **cms_t[name][cms_main], sizes=cms_t[name]))
    return [
        dict(name="staged_scatter", route="cuda",
             source="src/repro_torch/kernels/csrc/staged_scatter.cu",
             replaces="src/repro/kernels/staged_scatter.py:44",
             launches=None, max_abs_err=k1_err, **k1_t),
        dict(name="flash_decode_paged", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_decode_paged.cu",
             replaces="src/repro/kernels/flash_decode.py:135",
             launches=None, max_abs_err=max(k2_errs.values()), **k2_t),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:83",
             launches=None, max_abs_err=max(k3_errs.values()), **k3_t),
        dict(name="flash_decode", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_decode.cu",
             replaces="src/repro/kernels/flash_decode.py:271",
             launches=None, max_abs_err=max(k4_errs.values()), **k4_t),
    ] + cms_rows


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
    take_launches(kernels, counts, ("staged_scatter", "flash_decode_paged"))
    if counts["flash_attention"] <= 0:   # prefill runs K3 on this path too
        raise AssertionError(f"flash_attention was never launched by the "
                             f"paged engine: {counts}")
    engine_profile(eng, cfg, SLICE, PROMPT_LENS)
    del eng
    torch.cuda.empty_cache()


def take_launches(kernels, counts, names):
    """The launch counts of one main path's run, for the kernels it owns."""
    for k in kernels:
        if k["name"] in names:
            k["launches"] = counts[k["name"]]
            if k["launches"] <= 0:
                raise AssertionError(f"{k['name']} was never launched by "
                                     f"the engine: {counts}")


def phase_lanes(kernels):
    """The sliding-window model on the lanes layout: 12 requests, prompts of
    512 / 2048 / 4608 tokens (the longest past the 4096 window), 64 new
    tokens each, three timed serves in turn after an uncounted warm-up."""
    cfg = get_config(LANES["arch"])
    t0 = time.perf_counter()
    eng = Engine.from_config(EngineConfig(**LANES))
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    assert eng.layout == "lanes" and eng.attention == "reference", (
        eng.layout, eng.attention)
    t0 = time.perf_counter()
    eng.serve(synthetic_requests(len(LANES_PROMPTS), LANES_PROMPTS, cfg.vocab,
                                 2, params=SamplingParams(max_tokens=2)))
    eng.reset()
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    sp = SamplingParams(max_tokens=LANES_NEW)

    def timed_serve():
        queue = synthetic_requests(LANES_REQUESTS, LANES_PROMPTS, cfg.vocab,
                                   LANES_NEW, params=sp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.serve(queue)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, eng.completions()

    reset_launch_counts()           # counts = 0 just before the main path
    torch.cuda.reset_peak_memory_stats()
    outputs, dt, comps = timed_serve()
    counts = launch_counts()        # read just after
    peak = torch.cuda.max_memory_allocated()
    stats = dict(eng.stats)
    n_toks = sum(len(t) for t in outputs.values())
    seconds, ttfts = [dt], [sorted(c.ttft_s for c in comps.values())]
    for _ in range(ENGINE_RUNS - 1):
        eng.reset()
        again, dt_i, comps_i = timed_serve()
        seconds.append(dt_i)
        ttfts.append(sorted(c.ttft_s for c in comps_i.values()))
        for rid, toks in outputs.items():
            assert (again[rid] == toks).all(), f"request {rid} did not repeat"
    # one prefill call of a group of 4608-token prompts, device time
    prompts = torch.randint(0, cfg.vocab, (LANES_GROUP, max(LANES_PROMPTS)),
                            generator=torch.Generator(device=DEV).manual_seed(1),
                            device=DEV)
    prefill_ms = device_ms(
        lambda: eng.model.prefill(prompts, LANES["max_seq"]),
        "lanes prefill", reps=3)
    say("lanes", config=LANES, n_layers=cfg.n_layers, dtype=cfg.dtype,
        layout=eng.layout, requests=len(outputs), tokens=n_toks,
        seconds=seconds, tok_per_s=[n_toks / x for x in seconds],
        ttft_median_s=[x[len(x) // 2] for x in ttfts],
        ttft_min_max_s=[[x[0], x[-1]] for x in ttfts],
        prefill_device_ms=prefill_ms,
        prefill_shape=f"{LANES_GROUP} x {max(LANES_PROMPTS)} tokens",
        model_build_seconds=t_build, warm_up_seconds=t_warm, stats=stats,
        launches=counts, peak_mem_gb=peak / 1e9)
    assert len(outputs) == LANES_REQUESTS
    for rid, toks in outputs.items():
        assert toks.shape == (LANES_NEW,), (rid, toks.shape)
        assert ((toks >= 0) & (toks < cfg.vocab)).all(), rid
        pc = comps[rid].path_counts
        assert pc["direct"] == LANES_NEW - 1 and pc["staged"] == 0, pc
    assert stats["admitted"] == stats["retired"] == LANES_REQUESTS, stats
    assert stats["staged_writes"] == 0 and stats["drains"] == 0, stats
    take_launches(kernels, counts, ("flash_attention", "flash_decode"))
    engine_profile(eng, cfg, LANES, LANES_PROMPTS)
    del eng
    torch.cuda.empty_cache()


def engine_profile(eng, cfg, shape, prompt_lens):
    """Where one decode segment's time goes: 8 live slots, three segments
    timed on the host clock (the median is used), the next one under the
    profiler (device time by kernel name, and the device's busy share of the
    timed segment). The requests are long enough to stay live throughout."""
    eng.reset()
    sch = eng.scheduler
    n_new = 8 * shape["segment_len"]    # at most 7 segments run below
    sch.admit(synthetic_requests(
        shape["n_slots"], prompt_lens, cfg.vocab, n_new,
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
    # a retried trace runs one more segment: the requests stay live for it
    rows = trace_rows(sch.run_segment, f"{shape['arch']} segment")
    steps = shape["segment_len"]
    dev_ms = sum(r[0] for r in rows) / 1e3
    say("engine_profile", arch=shape["arch"], layout=eng.layout,
        slots=shape["n_slots"], steps=steps,
        segment_ms=seg, step_ms=seg_ms / steps,
        device_ms_per_step=dev_ms / steps,
        device_busy_share=dev_ms / seg_ms if dev_ms else None,
        launches_per_step=sum(r[1] for r in rows) / steps,
        top=[dict(kernel=k[:64], ms_per_step=us / 1e3 / steps,
                  calls_per_step=n / steps) for us, n, k in rows[:8]])


def phase_parity():
    """Smaller depth, full width, fp32: the write paths, the two paged read
    implementations and the two layouts must emit identical greedy token
    streams; so must the sliding-window model on the card and on the CPU."""
    cfg = dataclasses.replace(get_config(SLICE["arch"]), n_layers=4,
                              dtype="float32")
    model = build_model(cfg, device=DEV).init(1)
    shape = dict(max_seq=512, n_slots=4, page_size=16, segment_len=8,
                 ring_size=4)
    plens, new = [128, 200, 256], 24

    def run(path, attention, layout="auto"):
        eng = Engine.from_config(EngineConfig(
            path=path, attention=attention, kv_layout=layout, **shape), model)
        out = eng.serve(synthetic_requests(6, plens, cfg.vocab, new))
        stats = dict(eng.stats)
        assert eng.layout == ("paged" if layout == "auto" else layout)
        del eng
        torch.cuda.empty_cache()
        return out, stats

    base, base_stats = run("direct", "fused")
    report = {}
    for path, attention, layout in (
            ("staged", "fused", "auto"), ("adaptive", "fused", "auto"),
            ("adaptive", "reference", "auto"), ("staged", "reference", "auto"),
            ("direct", "auto", "lanes")):
        out, stats = run(path, attention, layout)
        for rid in base:
            if not (out[rid] == base[rid]).all():
                raise AssertionError(
                    f"token streams differ: {path}/{attention}/{layout} vs "
                    f"direct/fused, request {rid}: {out[rid]} vs {base[rid]}")
        report[f"{path}/{attention}/{layout}"] = {
            k: stats[k] for k in ("direct_writes", "staged_writes", "drains")}
    del model
    torch.cuda.empty_cache()
    swa = phase_parity_swa()
    say("parity", n_layers=cfg.n_layers, dtype=cfg.dtype, requests=len(base),
        tokens=sum(len(t) for t in base.values()), identical_streams=True,
        runs=report, swa=swa)


def phase_parity_swa():
    """h2o-danube-3-4b at 2 layers and full width, fp32, the window cut to
    128 so that it and the ring's wrap bite at short prompts: the engine on
    the card (flash_attention, flash_decode) and the same weights in a CPU
    engine (their plain versions) give identical greedy streams."""
    cfg = dataclasses.replace(get_config(LANES["arch"]), n_layers=2,
                              dtype="float32", sliding_window=128)
    shape = dict(max_seq=512, n_slots=4, segment_len=8, path="direct")
    plens, new = [100, 200, 300], 24
    gpu_model = build_model(cfg, device=DEV).init(2)
    cpu_model = build_model(cfg, device="cpu")
    cpu_model.load_state_dict(gpu_model.state_dict())
    outs = {}
    for dev, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        eng = Engine.from_config(EngineConfig(device=dev, **shape), model)
        assert eng.layout == "lanes"
        outs[dev] = eng.serve(synthetic_requests(6, plens, cfg.vocab, new))
        del eng
    for rid in outs["cpu"]:
        if not (outs["cuda"][rid] == outs["cpu"][rid]).all():
            raise AssertionError(
                f"sliding-window streams differ, card vs CPU, request {rid}: "
                f"{outs['cuda'][rid]} vs {outs['cpu'][rid]}")
    del gpu_model, cpu_model
    torch.cuda.empty_cache()
    return dict(arch=cfg.name, n_layers=cfg.n_layers, window=cfg.sliding_window,
                requests=len(outs["cpu"]),
                tokens=sum(len(t) for t in outs["cpu"].values()),
                identical_streams=True)


# ---------------------------------------------------------------------------
# the flat write engine
# ---------------------------------------------------------------------------


def write_stream(shape, gen, device):
    """The section 4 write stream, made on ``device`` from ``gen``: regions
    Zipf(0.5) over 2^log2_regions, offsets 64 x U{0..regions_elems/64 - 1}
    elements, sizes U{4..64} fp32 elements (16-256 B), payload [n, width],
    each write carrying its region's registration stag (registration i
    covers an equal share of the regions under stag 11 + i), and with
    ``bad_every`` > 0 about one write in that many carrying stag 99. Two
    writes of a batch either share (region, offset) or do not overlap."""
    n_regions = 1 << shape["log2_regions"]
    per_reg = n_regions // shape["registrations"]
    n, w = shape["batch"], shape["width"]
    stream = []
    for _ in range(shape["batches"]):
        region = zipf_regions(n, n_regions, 0.5, generator=gen, device=device)
        offset = 64 * torch.randint(0, shape["region_elems"] // 64, (n,),
                                    generator=gen, device=device)
        size = torch.randint(4, 65, (n,), generator=gen, device=device)
        stag = 11 + region // per_reg
        if shape["bad_every"]:
            bad = torch.randint(0, shape["bad_every"], (n,), generator=gen,
                                device=device) == 0
            stag = torch.where(bad, 99, stag)
        payload = torch.randn((n, w), generator=gen, device=device)
        stream.append((make_write_batch(region, offset, size), payload, stag))
    return stream


def check_stream_seeded(shape, stream, seed):
    """The stream is its seed's own: made again from the seed it is the
    same, and the card draws the regions the CPU draws from the same
    uniforms."""
    again = write_stream(shape, torch.Generator(device=DEV).manual_seed(seed),
                         DEV)
    for (b1, p1, s1), (b2, p2, s2) in zip(stream, again):
        if not all(torch.equal(x, y)
                   for x, y in zip((*b1, p1, s1), (*b2, p2, s2))):
            raise AssertionError("the write stream differs when made again "
                                 "from its seed")
    n_regions = 1 << shape["log2_regions"]
    u = torch.rand((1 << 20,), device=DEV,
                   generator=torch.Generator(device=DEV).manual_seed(seed))
    if not torch.equal(zipf_regions(0, n_regions, u=u).cpu(),
                       zipf_regions(0, n_regions, u=u.cpu())):
        raise AssertionError("zipf_regions: the card and the CPU draw other "
                             "regions from the same uniforms")


def write_table(shape, device):
    n_regions = 1 << shape["log2_regions"]
    per_reg = n_regions // shape["registrations"]
    table = make_umtt(shape["umtt"], device=device)
    for i in range(shape["registrations"]):
        table = register(table, i * per_reg, per_reg, stag=11 + i)
    return table


def write_engines(shape):
    """The four decision planes over one write engine shape. The sketch
    engines share one CMSMonitor: the frequency policy's also sits on the
    module (the module updates, the policy queries), the hysteresis
    policy owns its own."""
    depth, log2w = shape["cms"]
    cms = CMSMonitor(depth=depth, log2_width=log2w,
                     decay_every=shape["decay_every"])
    planes = {
        "direct": DecisionModule(policy=AlwaysOffload()),
        "staged": DecisionModule(policy=AlwaysUnload()),
        "adaptive-cms": DecisionModule(policy=FrequencyPolicy(
            monitor=cms, threshold=shape["threshold"]), monitor=cms),
        "hysteresis-cms": DecisionModule(policy=HysteresisPolicy(
            monitor=cms, lo=shape["lo"], hi=shape["hi"],
            n_regions=1 << shape["log2_regions"])),
    }
    return {name: RemoteWriteEngine(decision=d, ring_capacity=shape["ring"],
                                    width=shape["width"])
            for name, d in planes.items()}


def write_pass(eng, table, mem, stream):
    """One pass of the stream through a fresh engine state, then a flush."""
    st = eng.init_state(table, device=mem.device)
    for batch, payload, stag in stream:
        st, mem = eng.write(st, mem, batch, payload, stag)
    return eng.flush(st, mem)[0]


def _telemetry(st):
    return dict(n_offloaded=int(st.n_offloaded), n_unloaded=int(st.n_unloaded),
                n_rejected=int(st.n_rejected))


def _last_of_runs(keys):
    """bool mask of the last element of each run of equal sorted keys."""
    last = torch.ones_like(keys, dtype=torch.bool)
    last[:-1] = keys[1:] != keys[:-1]
    return last


def oracle_mem(shape, stream, device):
    """Sequential last-write-wins, written independently of the engine: a
    write is dropped when a later write of its batch has the same (region,
    offset); of the others, each element holds the last write that covers
    it. Every stag of this stream is valid."""
    n_regions, re = 1 << shape["log2_regions"], shape["region_elems"]
    n = shape["batch"]
    total = n * len(stream)
    key = torch.cat([b.region * re + b.offset for b, _, _ in stream])
    size = torch.cat([b.size for b, _, _ in stream])
    payload = torch.cat([p for _, p, _ in stream])
    order = torch.arange(total, device=device)
    # within a batch, the last write per key survives
    comb = ((order // n) * (n_regions * re) + key) * total + order
    comb, _ = torch.sort(comb)
    keep = torch.zeros(total, dtype=torch.bool, device=device)
    keep[(comb % total)[_last_of_runs(comb // total)]] = True
    # element by element, the last surviving write wins
    w = shape["width"]
    lane = torch.arange(w, device=device)
    elem = keep[:, None] & (lane[None] < size[:, None])
    flat = (key[:, None] + lane[None])[elem]
    src = (order[:, None] * w + lane[None])[elem]
    comb2, perm = torch.sort(flat * (total * w) + src)
    win = _last_of_runs(comb2 // (total * w))
    mem = torch.zeros((n_regions, re), dtype=torch.float32, device=device)
    mem.view(-1)[flat[perm][win]] = payload.reshape(-1)[src[perm][win]]
    return mem


def phase_write_engine(kernels):
    """The paper's flat write engine at its section 4 size on the card."""
    shape = WRITE
    gen = torch.Generator(device=DEV).manual_seed(13)
    n_regions = 1 << shape["log2_regions"]
    stream = write_stream(shape, gen, DEV)
    check_stream_seeded(shape, stream, 13)
    table = write_table(shape, DEV)
    n_writes = shape["batches"] * shape["batch"]
    report, ref_mem, totals = {}, None, {"cms_update": 0, "cms_query": 0}
    for name, eng in write_engines(shape).items():
        torch.cuda.reset_peak_memory_stats()
        mem = torch.zeros((n_regions, shape["region_elems"]),
                          dtype=torch.float32, device=DEV)
        write_pass(eng, table, mem, stream)      # warm-up, not counted
        torch.cuda.synchronize()
        seconds = []
        for i in range(3):
            if i == 0:
                reset_launch_counts()   # counts = 0 just before the main path
            t0 = time.perf_counter()
            st = write_pass(eng, table, mem, stream)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            if i == 0:
                counts = launch_counts()        # read just after
                tel = _telemetry(st)
        ev = trace_rows(lambda: write_pass(eng, table, mem, stream),
                        f"write_engine {name}")
        dev_ms = sum(e[0] for e in ev) / 1e3
        host_ms = sorted(seconds)[1] * 1e3 / shape["batches"]
        per_batch = {k: counts[k] / shape["batches"]
                     for k in ("cms_update", "cms_query")}
        report[name] = dict(
            writes_per_s=[n_writes / x for x in seconds],
            host_ms_per_batch=host_ms,
            device_ms_per_batch=dev_ms / shape["batches"],
            device_busy_share=dev_ms / shape["batches"] / host_ms,
            kernel_launches_per_batch=sum(e[1] for e in ev)
            / shape["batches"],
            top=[dict(kernel=k[:64], ms_per_batch=us / 1e3 / shape["batches"],
                      calls_per_batch=c / shape["batches"])
                 for us, c, k in ev[:8]],
            cms_launches_per_batch=per_batch, **tel,
            unload_share=tel["n_unloaded"] / n_writes,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        sketch = name.endswith("-cms")
        want = 1.0 if sketch else 0.0
        if per_batch != {"cms_update": want, "cms_query": want}:
            raise AssertionError(f"{name}: sketch launches per batch "
                                 f"{per_batch}, expected {want}")
        if sketch:
            for k in totals:
                totals[k] += counts[k]
            if not 0.0 < report[name]["unload_share"] < 1.0:
                raise AssertionError(f"{name}: unload share "
                                     f"{report[name]['unload_share']}")
        if tel["n_rejected"] != 0:
            raise AssertionError(f"{name}: {tel['n_rejected']} rejected")
        if ref_mem is None:
            ref_mem = mem
            oracle = oracle_mem(shape, stream, DEV)
            if not torch.equal(mem, oracle):
                raise AssertionError("direct engine's memory differs from "
                                     "the last-write-wins oracle")
            del oracle
        else:
            if not torch.equal(mem, ref_mem):
                raise AssertionError(f"{name}: memory differs from the "
                                     f"direct engine's")
            del mem
        torch.cuda.empty_cache()
    del ref_mem
    torch.cuda.empty_cache()
    say("write_engine", shape=shape, writes=n_writes, engines=report,
        identical_memories=True, matches_oracle=True, stream_seeded=True,
        memory_gb=n_regions * shape["region_elems"] * 4 / 2 ** 30)
    for k in kernels:
        if k["name"] in totals:
            k["launches"] = totals[k["name"]]


def phase_write_parity():
    """The four engines on the card and on the CPU, small, bad stags in the
    stream: memory, telemetry and ring state identical."""
    shape = WRITE_PARITY
    gen = torch.Generator(device="cpu").manual_seed(14)
    n_regions = 1 << shape["log2_regions"]
    cpu_stream = write_stream(shape, gen, "cpu")
    dev_stream = [(type(b)(*(t.to(DEV) for t in b)), p.to(DEV), s.to(DEV))
                  for b, p, s in cpu_stream]
    report = {}
    for name, eng in write_engines(shape).items():
        out = {}
        for dev, stream in ((DEV, dev_stream), ("cpu", cpu_stream)):
            mem = torch.zeros((n_regions, shape["region_elems"]),
                              dtype=torch.float32, device=dev)
            st = write_pass(eng, write_table(shape, dev), mem, stream)
            out[str(dev)] = (mem.cpu(), _telemetry(st), st.ring.live.cpu(),
                             int(st.ring.head))
        (m_c, t_c, l_c, h_c), (m_p, t_p, l_p, h_p) = out[str(DEV)], out["cpu"]
        if not torch.equal(m_c, m_p):
            raise AssertionError(f"{name}: memory differs, card vs CPU")
        if t_c != t_p or h_c != h_p or not torch.equal(l_c, l_p):
            raise AssertionError(f"{name}: telemetry or ring differs, card "
                                 f"{t_c} head {h_c} vs CPU {t_p} head {h_p}")
        if t_c["n_rejected"] == 0 and name != "direct":
            raise AssertionError(f"{name}: no bad stag was rejected")
        report[name] = t_c
    say("write_parity", shape=shape, engines=report, identical=True)


def main():
    t0 = time.perf_counter()
    card = phase_env()
    phase_build()
    kernels = phase_kernels()
    phase_engine(kernels)
    phase_lanes(kernels)
    phase_parity()
    phase_write_engine(kernels)
    phase_write_parity()
    say("done", seconds=round(time.perf_counter() - t0, 1),
        traces_without_device_time=TRACE_MISSES)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
