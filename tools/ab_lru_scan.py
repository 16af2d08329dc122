#!/usr/bin/env python3
"""Two checkouts' ``lru_scan`` against each other, on one GPU.

Runs checkout A, then B, B and A, each in a process of its own, so that both
are timed in turns on the same card. Each run builds its checkout's kernels
and, through that checkout's ``chip_smoke.py``, times ``lru_scan`` on the
paper workload's regions (seed 0, every write offloaded) at 2^20, 1, 4 and
16 regions (200 000 writes) and at 2^20 regions with 5 000 000 writes
(device ms from the profiler's trace, mean of 20 calls, and the CUDA-event
ms of one call), then one Fig. 3 sweep point's device ms (``sweep_point``
with ``AlwaysOffload``) at 2^20, 1 region and the 5 000 000-write headline,
as the ``fig3`` phase times them. The hit counts must agree between the
runs.

    python3 tools/ab_lru_scan.py A_DIR B_DIR

Each directory is the root of a checkout, for example a ``git archive`` of
the parent commit unpacked into a git-ignored directory. Needs a CUDA
device and ``nvcc``. The last line of the output is one JSON object with
every run.
"""
import json
import os
import subprocess
import sys

SHAPES = (("2e20", 1 << 20, "sim"), ("1", 1, "sim"), ("4", 4, "sim"),
          ("16", 16, "sim"), ("2e20_5M", 1 << 20, "all"))


def one(root, tag):
    """Run in a child process: ``root``'s lru_scan on the card."""
    sys.path.insert(0, root)
    import chip_smoke as cs
    import torch

    assert os.path.dirname(os.path.abspath(cs.__file__)) == root, cs.__file__
    card = cs.phase_env()
    cs.phase_build()
    pw = cs.PAPER_WORKLOAD
    scan = {}
    for name, r, which in SHAPES:
        n = pw.sim_writes if which == "sim" else pw.n_writes
        regions = cs._paper_regions(r, n=n)
        unload = torch.zeros((n,), dtype=torch.bool, device=cs.DEV)
        fn = lambda: cs.lru_scan(regions, unload)  # noqa: E731
        scan[name] = dict(ms=cs.device_ms(fn, f"{tag} lru_scan {name}"),
                          event_ms=cs.time_ms(fn), hits=int(fn().sum()))
    key = cs.prng.key(0)
    point = {}
    for name, r, n in (("2e20", 1 << 20, pw.sim_writes),
                       ("1", 1, pw.sim_writes),
                       ("2e20_5M", 1 << 20, pw.n_writes)):
        point[name] = cs.device_ms(
            lambda: cs.sweep_point(key, r, n, n // 10, cs.AlwaysOffload()),
            f"{tag} fig3 point {name}", reps=3)
    print(json.dumps(dict(tag=tag, root=root, card=card, lru_scan=scan,
                          point_device_ms=point)), flush=True)


def main():
    if sys.argv[1] == "--one":
        return one(os.path.abspath(sys.argv[2]), sys.argv[3])
    a, b = (os.path.abspath(d) for d in sys.argv[1:3])
    runs = []
    for root, tag in ((a, "A1"), (b, "B1"), (b, "B2"), (a, "A2")):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root, tag],
            capture_output=True, text=True, check=True).stdout
        run = json.loads(out.strip().splitlines()[-1])
        runs.append(run)
        for name, t in run["lru_scan"].items():
            print(tag, "lru_scan", name, "ms", t["ms"], "event_ms",
                  t["event_ms"], "hits", t["hits"], flush=True)
        print(tag, "fig3 point device ms", run["point_device_ms"], flush=True)
    hits = {name: {r["tag"]: r["lru_scan"][name]["hits"] for r in runs}
            for name, _, _ in SHAPES}
    same = all(len(set(h.values())) == 1 for h in hits.values())
    print(json.dumps(dict(runs=runs, hits_agree=same)), flush=True)
    if not same:
        sys.exit(f"hit counts differ between the runs: {hits}")


if __name__ == "__main__":
    main()
