#!/usr/bin/env python3
"""Two checkouts against each other on the flat write engine, on one GPU.

Runs ``chip_smoke.py``'s ``write_engine`` phase of checkout A, then B, B
and A, each in a process of its own, so that both are measured in turns on
the same card. For every decision plane it prints the phase's own numbers
(device and host ms per batch, trace rows per batch) and, from one more
profiled pass of the same stream, the device's operations per batch (rows
with device time) apart from the runtime's calls, and every kernel whose
count per batch differs between A and B.

    python3 tools/ab_write_engine.py A_DIR B_DIR

Each directory is the root of a checkout, for example a ``git archive`` of
the parent commit unpacked into a git-ignored directory. Needs a CUDA
device and ``nvcc``; each checkout builds its own kernels. The last line
of the output is one JSON object with every run.
"""
import json
import os
import subprocess
import sys


def one(root, tag):
    """Run in a child process: ``root``'s chip_smoke on the card."""
    sys.path.insert(0, root)
    import chip_smoke as cs
    import torch

    assert os.path.dirname(os.path.abspath(cs.__file__)) == root, cs.__file__
    card = cs.phase_env()
    cs.phase_build()
    cs.phase_write_engine([])
    shape = cs.WRITE
    stream = cs.write_stream(
        shape, torch.Generator(device=cs.DEV).manual_seed(13), cs.DEV)
    table = cs.write_table(shape, cs.DEV)
    planes = {}
    for name, eng in cs.write_engines(shape).items():
        mem = torch.zeros((1 << shape["log2_regions"], shape["region_elems"]),
                          dtype=torch.float32, device=cs.DEV)
        cs.write_pass(eng, table, mem, stream)      # warm
        rows = cs.trace_rows(lambda: cs.write_pass(eng, table, mem, stream),
                             f"{tag} {name}")
        nb = shape["batches"]
        planes[name] = dict(
            device_ops_per_batch=sum(c for us, c, _ in rows if us > 0) / nb,
            runtime_calls_per_batch=sum(c for us, c, _ in rows if us <= 0)
            / nb,
            device_ms_per_batch=sum(us for us, _, _ in rows) / 1e3 / nb,
            by_name={k: c / nb for _, c, k in rows})
        del mem
        torch.cuda.empty_cache()
    print(json.dumps(dict(tag=tag, root=root, card=card, planes=planes)),
          flush=True)


def main():
    if sys.argv[1] == "--one":
        return one(os.path.abspath(sys.argv[2]), sys.argv[3])
    a, b = (os.path.abspath(d) for d in sys.argv[1:3])
    runs = []
    for root, tag in ((a, "A1"), (b, "B1"), (b, "B2"), (a, "A2")):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root, tag],
            capture_output=True, text=True, check=True).stdout
        lines = out.strip().splitlines()
        run = json.loads(lines[-1])
        for ln in lines:
            if ln.startswith('{"phase": "write_engine"'):
                run["phase"] = json.loads(ln)["engines"]
        runs.append(run)
        for name, p in run["planes"].items():
            ph = run["phase"][name]
            print(tag, name, "device ms/batch", ph["device_ms_per_batch"],
                  "host ms/batch", ph["host_ms_per_batch"],
                  "trace rows/batch", ph["kernel_launches_per_batch"],
                  "device ops/batch", p["device_ops_per_batch"], flush=True)
    diff = {}
    for name in runs[0]["planes"]:
        names = set()
        for r in runs:
            names |= set(r["planes"][name]["by_name"])
        for k in sorted(names):
            per = [r["planes"][name]["by_name"].get(k, 0.0) for r in runs]
            if abs((per[1] + per[2]) - (per[0] + per[3])) > 0.1:
                diff.setdefault(name, []).append(dict(name=k[:120],
                                                      a_b_b_a=per))
    print(json.dumps(dict(card=runs[0]["card"], runs=[
        {k: v for k, v in r.items() if k != "planes"} | {"planes": {
            n: {k: v for k, v in p.items() if k != "by_name"}
            for n, p in r["planes"].items()}} for r in runs],
        changed_kernels=diff)), flush=True)


if __name__ == "__main__":
    main()
