"""Port of repro/launch/report.py: the dry-run tables from the JSON records
of ``launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.report [--dir experiments/dryrun_torch]

The same two tables as the JAX package's, from the same record keys; the
time column is the full-depth cell's build on the host (``build_s``), where
the JAX package's is its compile (``compile_s``).
"""
from __future__ import annotations

import argparse
import json
import os

from ..configs import ALL_SHAPES, ARCHS


def load(dirname):
    recs = {}
    for fname in sorted(os.listdir(dirname)):
        if fname.endswith(".json"):
            with open(os.path.join(dirname, fname)) as f:
                r = json.load(f)
            recs[(r["arch"], r["shape"])] = r
    return recs


def fmt_ms(s):
    return f"{s*1e3:.2f}"


def render(recs) -> str:
    lines = ["### §Dry-run: build + memory per (arch x shape), both meshes\n",
             "| arch | shape | status | mem/dev 1-pod (GB) | mem/dev 2-pod (GB) "
             "| build 1-pod (s) | build 2-pod (s) |",
             "|---|---|---|---|---|---|---|"]
    for arch in ARCHS:
        for shape in ALL_SHAPES:
            r = recs.get((arch, shape.name))
            if r is None:
                lines.append(f"| {arch} | {shape.name} | MISSING | | | | |")
                continue
            if r["status"] == "skipped":
                lines.append(f"| {arch} | {shape.name} | skipped* | | | | |")
                continue
            if r["status"] == "error":
                lines.append(f"| {arch} | {shape.name} | ERROR | | | | |")
                continue
            sp, mp = r["single_pod"], r["multi_pod"]
            lines.append(f"| {arch} | {shape.name} | ok | {sp['per_device_gb']} | "
                         f"{mp['per_device_gb']} | {sp['build_s']} | {mp['build_s']} |")

    lines += ["\n### §Roofline: per-device terms (single-pod 16x16, 256 chips)\n",
              "| arch | shape | compute (ms) | memory (ms) | collective (ms) | "
              "dominant | model-FLOPs ratio | roofline frac |",
              "|---|---|---|---|---|---|---|---|"]
    for arch in ARCHS:
        for shape in ALL_SHAPES:
            r = recs.get((arch, shape.name))
            if not r or r["status"] != "ok" or "roofline" not in r:
                continue
            t = r["roofline"]
            lines.append(f"| {arch} | {shape.name} | {fmt_ms(t['compute_s'])} | "
                         f"{fmt_ms(t['memory_s'])} | {fmt_ms(t['collective_s'])} | "
                         f"{t['dominant']} | {t['model_flops_ratio']:.2f} | "
                         f"{t['roofline_fraction']:.3f} |")

    n_ok = sum(1 for r in recs.values() if r["status"] == "ok")
    n_skip = sum(1 for r in recs.values() if r["status"] == "skipped")
    n_err = sum(1 for r in recs.values() if r["status"] == "error")
    lines.append(f"\ncells: {n_ok} ok / {n_skip} skipped (documented) / {n_err} error")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    args = ap.parse_args()
    print(render(load(args.dir)))


if __name__ == "__main__":
    main()
