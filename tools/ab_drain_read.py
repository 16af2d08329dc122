#!/usr/bin/env python3
"""Two checkouts' paged drain (K1) and sharded read (K2s) against each other,
on one GPU.

Runs checkout A, then B, B and A, each in a process of its own, so that both
are timed in turns on the same card. Each run builds its checkout's kernels
and, through that checkout's ``chip_smoke.py`` and public API, takes the
profiler's trace (device time by kernel name, mean of 20 calls) of:

  drain         ``kvcache.paged.drain_ring`` on the engine's cache (stablelm-
                1.6b at full width: 24 layers, 1024 blocks of 16 rows, 32
                heads of 64, bf16; 8 slots x a full ring of 8, every entry
                live), its ring restored before each call (one copy)
  drain_empty   ``kvcache.paged.maybe_drain`` on the same cache with the ring
                not full: the gated in-segment drain, no entry valid
  drain_tp4     ``drain_ring`` on the same cache split in 4 on the head axis
                over a virtual mesh of the card
  moe_drain     ``staged_scatter`` at granite-moe-3b-a800m's decode-step
                drain (``dest[320,1536]``, 64 staged rows, bf16)
  read_tp4      ``flash_decode_paged_sharded`` at the engine's decode shape
                on a tp-4 virtual mesh, and ``flash_decode_paged`` on the
                same operands (``read_unsharded``)

The drains are timed cold, as the engine drains (a decode step reads GBs of
weights and keys between two drains): each call takes the next of as many
caches (MoE: dest and staging buffers) as fill four times the card's L2, so
its bytes come from HBM as a bytes bound counts them. Each also gives
``l2_warm``, the same cache every call, its bytes in the L2. Then
``engine_profile`` (one 16-step decode segment, 8 live slots) of the
engine phase's configuration unsharded and at tp 4 on a virtual mesh. Each
row of a trace is ``[kernel name, calls a call, device us a call]``. The
outputs of the drains and reads must agree between the runs.

    python3 tools/ab_drain_read.py A_DIR B_DIR
    python3 tools/ab_drain_read.py --one DIR TAG [--no-steps]
        (one run, no turns; ``--no-steps`` leaves out the engine profiles)

Each directory is the root of a checkout, for example a ``git archive`` of
the parent commit unpacked into a git-ignored directory. Needs a CUDA
device and ``nvcc``. The last line of the output is one JSON object with
every run.
"""
import hashlib
import itertools
import json
import os
import subprocess
import sys

REPS = 20
# the engine's pool: layers, blocks, rows a block, slots, pages a slot, KV
# heads, head_dim, ring lanes
POOL = (24, 1024, 16, 8, 128, 32, 64, 8)


def _rows(cs, fn, what):
    """``[name, calls a call, device us a call]`` per kernel of ``fn``, and
    the device ms a call in all."""
    fn()
    def run():
        for _ in range(REPS):
            fn()
    rows = cs.trace_rows(run, what)
    out = [[name[:140], n / REPS, us / REPS] for us, n, name in rows if us > 0]
    return dict(device_ms=sum(r[2] for r in out) / 1e3, rows=out)


def _cold_sets(torch, dev, nbytes):
    """How many sets of buffers, ``nbytes`` each, fill four times the card's
    L2 (as ``chip_smoke.cold_sets``, which a parent checkout may lack)."""
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    return max(2, -(-4 * l2 // nbytes))


def _cold(cs, fn, sets, what):
    """``_rows`` of ``fn(*s)`` over ``sets`` in turn (cold), with
    ``l2_warm`` the rows of ``fn(*sets[0])`` every call."""
    it = itertools.cycle(sets)
    t = _rows(cs, lambda: fn(*next(it)), what)
    t["l2_warm"] = _rows(cs, lambda: fn(*sets[0]), f"{what} warm")
    t["cold_sets"] = len(sets)
    return t


def _digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _cache(cs, torch, mesh=None):
    """The engine's paged cache with a full ring of live entries: every slot
    owns 128 distinct blocks, its 8 lanes staged at 8 consecutive rows."""
    from repro_torch.distributed import pieces
    gen = cs.timed_gen(131)
    dev = cs.DEV
    l, nb, ps, slots, pages, h, dh, r = POOL
    cache = cs.PG.make_paged_kv(l, nb, ps, slots, pages, h, dh,
                                torch.bfloat16, ring_size=r, device=dev,
                                mesh=mesh)
    for name in ("ring_k", "ring_v"):
        whole = torch.randn(tuple(cache[name].shape), generator=gen,
                            device=dev).to(torch.bfloat16)
        parts = pieces(cache[name])
        n = len(parts)
        for j, p in enumerate(parts):
            p.copy_(whole.chunk(n, dim=3)[j] if n > 1 else whole)
    cache["page_table"].copy_(
        torch.randperm(nb, generator=gen, device=dev)[:slots * pages]
        .view(slots, pages))
    base = torch.randint(0, pages * ps - r, (slots, 1), generator=gen,
                         device=dev)
    pos = base + torch.arange(r, device=dev)[None]
    cache["ring_pos"].copy_(pos)
    cache["ring_fill"] = torch.full((), r, dtype=torch.int64, device=dev)
    return cache, pos


def _drain_case(cs, torch, mesh, tag, what):
    """The drain timed cold over caches that fill 4x the L2 (each drain
    reads its ring and writes as many bytes of pool rows); returns the
    times and the caches with their ring positions."""
    from repro_torch.distributed import pieces
    l, _, _, slots, _, h, dh, r = POOL
    n = _cold_sets(torch, cs.DEV, 2 * 2 * l * slots * r * h * dh * 2)
    caches = [_cache(cs, torch, mesh) for _ in range(n)]
    full = caches[0][0]["ring_fill"].clone()

    def drain(cache, pos):
        cache["ring_pos"].copy_(pos)
        cache["ring_fill"] = full
        cs.PG.drain_ring(cache)
    t = _cold(cs, drain, caches, f"{tag} {what}")
    cache = caches[0][0]
    t["digest"] = _digest(*pieces(cache["pages_k"]), *pieces(cache["pages_v"]))
    return t, caches


def one(root, tag, steps=True):
    """Run in a child process: ``root``'s drains, reads and (with
    ``steps``) decode steps on the card."""
    sys.path.insert(0, root)
    import chip_smoke as cs
    import torch

    assert os.path.dirname(os.path.abspath(cs.__file__)) == root, cs.__file__
    card = cs.phase_env()
    cs.phase_build()
    out = dict(tag=tag, root=root, card=card)
    out["drain"], caches = _drain_case(cs, torch, None, tag, "drain")
    # the gated drain with nothing due: the ring holds 7 of its 8 columns
    for cache, pos in caches:
        cache["ring_pos"].copy_(pos)
        cache["ring_fill"] = torch.full((), POOL[-1] - 1, dtype=torch.int64,
                                        device=cs.DEV)
    out["drain_empty"] = _cold(cs, lambda cache, _: cs.PG.maybe_drain(cache),
                               caches, f"{tag} drain_empty")
    del caches, cache
    torch.cuda.empty_cache()
    out["drain_tp4"], caches = _drain_case(
        cs, torch, cs._virtual_mesh(4), tag, "drain_tp4")
    del caches
    torch.cuda.empty_cache()
    dest, staging, dst, ok = cs._moe_k1_inputs(cs.timed_gen(121),
                                               cs.MOE["n_slots"])
    n = _cold_sets(torch, cs.DEV, 2 * int(ok.sum()) * staging.shape[1] * 2)
    sets = [(dest.clone(), staging.clone()) for _ in range(n)]
    out["moe_drain"] = _cold(
        cs, lambda d, s: cs.staged_scatter(d, s, dst, ok), sets,
        f"{tag} moe_drain")
    out["moe_drain"]["digest"] = _digest(sets[0][0])
    args = cs._k2_engine_inputs(cs.timed_gen(109))
    mesh = cs._virtual_mesh(4)
    placed = cs._place_heads(args, mesh)
    out["read_tp4"] = _rows(
        cs, lambda: cs.flash_decode_paged_sharded(mesh, *placed),
        f"{tag} read_tp4")
    out["read_tp4"]["digest"] = _digest(
        cs.flash_decode_paged_sharded(mesh, *placed))
    out["read_unsharded"] = _rows(cs, lambda: cs.flash_decode_paged(*args),
                                  f"{tag} read_unsharded")
    out["engine_profile"] = {}
    cfg = cs.get_config(cs.SLICE["arch"])
    for name, tp in (("paged", 1), ("tp4", 4)) if steps else ():
        shape = dict(cs.SLICE, attention="fused")
        par = dict(parallel=cs.ParallelConfig.tensor(tp)) if tp > 1 else {}
        with cs.virtual_devices(tp):
            eng = cs.Engine.from_config(cs.EngineConfig(**shape, **par))
        prof = cs.engine_profile(eng, cfg, cs.SLICE, cs.PROMPT_LENS)
        out["engine_profile"][name] = {k: prof[k] for k in (
            "step_ms", "device_ms_per_step", "device_ops_per_step",
            "device_busy_share", "top")}
        del eng
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main():
    if sys.argv[1] == "--one":
        return one(os.path.abspath(sys.argv[2]), sys.argv[3],
                   "--no-steps" not in sys.argv[4:])
    a, b = (os.path.abspath(d) for d in sys.argv[1:3])
    runs = []
    for root, tag in ((a, "A1"), (b, "B1"), (b, "B2"), (a, "A2")):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root, tag],
            capture_output=True, text=True)
        if res.returncode != 0:
            sys.exit(f"{tag} ({root}) failed:\n{res.stderr[-4000:]}")
        run = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append(run)
        for case in ("drain", "drain_empty", "drain_tp4", "moe_drain",
                     "read_tp4", "read_unsharded"):
            print(tag, case, "device_ms", run[case]["device_ms"],
                  "l2_warm", run[case].get("l2_warm", {}).get("device_ms"),
                  flush=True)
        for name, p in run["engine_profile"].items():
            print(tag, "step", name, "device_ms", p["device_ms_per_step"],
                  "ops", p["device_ops_per_step"], "host_ms", p["step_ms"],
                  flush=True)
    digests = {case: {r["tag"]: r[case]["digest"] for r in runs}
               for case in ("drain", "drain_tp4", "moe_drain", "read_tp4")}
    same = all(len(set(d.values())) == 1 for d in digests.values())
    print(json.dumps(dict(runs=runs, outputs_agree=same, digests=digests)),
          flush=True)
    if not same:
        sys.exit(f"outputs differ between the runs: {digests}")


if __name__ == "__main__":
    main()
