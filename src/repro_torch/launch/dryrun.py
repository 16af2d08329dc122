"""Port of repro/launch/dryrun.py: the multi-pod dry-run, on the
``meta`` device.

For every (architecture x input shape) cell this builds the full-depth
program on BOTH abstract meshes (no device, no allocation):

    single-pod:  (16, 16)      = ("data", "model")        256 GPUs
    multi-pod:   (2, 16, 16)   = ("pod", "data", "model") 512 GPUs

and records per mesh its memory fit against one H100's 80 GB: the resident
state (masters, AdamW moments, KV cache, batch; exact from the specs,
``cells.resident_bytes``) plus the peak of the step's live transient bytes
(counted on the meta depth probes and extrapolated in depth,
``roofline.probe_cell``). The roofline terms come from the single-pod
probes, priced at the slowest device's counts (``rank_balance``: its
products and bytes over the mean, and the unattributed shares).
``build_s`` is the seconds the full-depth cell takes to build on
the host's CPU (JAX's ``compile_s``).

Usage (CPU only, no GPU needed):
    python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--out experiments/dryrun_torch]
    python -m repro_torch.launch.dryrun --all --skip-probes   # build-only pass
"""
import argparse
import json
import os
import time
import traceback

from ..configs import ALL_SHAPES, ARCHS, get_config, get_shape, shape_applicable
from ..kernels.cost import HBM_BYTES
from . import cells as C
from . import roofline as R
from .mesh import make_production_mesh


def run_cell(arch: str, shape_name: str, *, probes: bool = True,
             dispatch_mode: str = "staged") -> dict:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped", "reason": why}

    rec: dict = {"arch": arch, "shape": shape_name, "status": "ok",
                 "dispatch_mode": dispatch_mode if cfg.n_experts else None}
    for mesh_kind, multi_pod in (("single_pod", False), ("multi_pod", True)):
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
        t0 = time.time()
        step, args, meta = C.build_cell(cfg, shape, mesh,
                                        dispatch_mode=dispatch_mode)
        build_s = round(time.time() - t0, 1)
        del step, args
        memory = C.resident_bytes(cfg, shape, mesh)
        resident = sum(memory.values())
        one = {"build_s": build_s, **meta}
        if probes:
            t0 = time.time()
            metrics = R.probe_cell(cfg, shape, mesh, dispatch_mode=dispatch_mode)
            one["probe_s"] = round(time.time() - t0, 1)
            memory["transient_peak"] = int(metrics.pop("peak_bytes"))
            if not multi_pod:
                rec["metrics"] = metrics
                rec["roofline"] = R.roofline_terms(metrics, cfg, shape)
                rec["rank_balance"] = R.rank_balance(metrics)
        total = sum(memory.values())
        one.update(memory=memory, per_device_gb=round(total / 2**30, 3),
                   resident_gb=round(resident / 2**30, 3),
                   fits_80gb=total <= HBM_BYTES)
        rec[mesh_kind] = one
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-probes", action="store_true")
    ap.add_argument("--dispatch-mode", default="staged",
                    choices=("direct", "staged", "adaptive"))
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true",
                    help="resume a sweep: skip cells with an ok/skipped JSON")
    args = ap.parse_args()

    cells = []
    if args.all:
        for arch in ARCHS:
            for shape in ALL_SHAPES:
                cells.append((arch, shape.name))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells.append((args.arch, args.shape))

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch, shape in cells:
        tag = f"{arch}__{shape}"
        path = os.path.join(args.out, tag + ".json")
        if args.skip_existing and os.path.exists(path):
            with open(path) as f:
                old = json.load(f)
            if old.get("status") in ("ok", "skipped"):
                print(f"[cached ] {tag}", flush=True)
                continue
        try:
            rec = run_cell(arch, shape, probes=not args.skip_probes,
                           dispatch_mode=args.dispatch_mode)
        except Exception as e:  # noqa: BLE001 — record and continue the sweep
            rec = {"arch": arch, "shape": shape, "status": "error",
                   "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc(limit=8)}
            failures += 1
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        status = rec["status"]
        extra = ""
        if status == "ok":
            extra = (f" mem/dev {rec['single_pod']['per_device_gb']}GB"
                     f" build {rec['single_pod']['build_s']}s"
                     f"+{rec['multi_pod']['build_s']}s")
            if "roofline" in rec:
                r = rec["roofline"]
                extra += (f" | compute {r['compute_s']*1e3:.2f}ms"
                          f" mem {r['memory_s']*1e3:.2f}ms"
                          f" coll {r['collective_s']*1e3:.2f}ms"
                          f" -> {r['dominant']}")
        elif status == "skipped":
            extra = " " + rec["reason"][:60]
        else:
            extra = " " + rec["error"][:90]
        print(f"[{status:7s}] {tag}{extra}", flush=True)
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


if __name__ == "__main__":
    main()
