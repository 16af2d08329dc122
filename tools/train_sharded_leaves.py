#!/usr/bin/env python3
"""Each gradient leaf of ``chip_smoke.py``'s train_sharded arms against the
unsharded step's, beside the card's own run-to-run floor.

For each named arm (``chip_smoke.TRAIN_SHARDED_ARMS``, in fp32, the arm's
weights, gates and first TRAIN batch): the unsharded step at TRAIN's
microbatches, the same step again from the same weights, the unsharded
step at as many microbatches again as the mesh has data ranks (each a data
rank's rows: the same function, a device's matrix-product shapes), and
the sharded step on the
arm's mesh of virtual devices, or on ``(data, model)`` of another shape
given after the arm's tag (``vlm_2x2:2x1`` splits the rows only,
``vlm_2x2:1x2`` the model only). For every gradient leaf, as shares of
``PARITY_GRAD_RTOL`` of the leaf's own largest entry: the largest
difference of the repeat (``repeat``: the card's own floor), of the
smaller microbatches (``rows``: the row count alone) and of the sharded
step (``sharded``) from the first step, and of the sharded step from the
smaller microbatches' (``sharded_vs_reference``); for a 0-d leaf (the
VLM's gates) also the four values and ``sharded_held``, the sharded
share of the tolerance ``train_sharded`` holds it to
(``chip_smoke._grad_tolerance``, the smaller microbatches giving its noise
floor, as they do on ``(2, 2)``).

    python3 tools/train_sharded_leaves.py vlm_2x2 [vlm_2x2:2x1 ...]

Needs a CUDA device and ``nvcc``. Prints one JSON line an arm: the ten
leaves with the largest ``sharded``, ``repeat`` and
``sharded_vs_reference`` shares, and every 0-d leaf.
"""
import dataclasses
import json
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import chip_smoke as CS  # noqa: E402


def _grads(cfg, mode, shape, microbatches):
    """The gradients of one fp32 step of ``microbatches`` microbatches, on
    the card (sharded on ``shape`` virtual devices where given)."""
    model = CS._sharded_model(cfg, mode)
    opt = CS._KeptGrads(CS.AdamW(lr=CS.warmup_cosine(
        CS.TRAIN["lr"], CS.TRAIN["warmup"], 1)), device=CS.DEV)
    par = None if shape is None else CS.ParallelConfig(shape,
                                                       ("data", "model"))
    with CS.virtual_devices(math.prod(shape or (1,))):
        st = CS.init_train_state(model, opt, None, 0, parallel=par)
    step = CS.make_train_step(model, opt, microbatches=microbatches,
                              mesh=st.mesh)
    step(st, CS._sharded_batches(cfg)(0))
    kept = opt.kept[0]
    del st, step, model, opt
    CS.torch.cuda.empty_cache()
    return kept


def main(tags):
    CS.phase_env()
    CS.phase_build()
    arms = {a[0]: a for a in CS.TRAIN_SHARDED_ARMS}
    for arg in tags:
        tag, _, mesh = arg.partition(":")
        _, arch, over, shape, mode = arms[tag]
        if mesh:
            shape = tuple(int(x) for x in mesh.split("x"))
        cfg = dataclasses.replace(CS.get_config(arch), dtype="float32",
                                  **over)
        mb = CS.TRAIN["microbatches"]
        first = _grads(cfg, mode, None, mb)
        again = _grads(cfg, mode, None, mb)
        ref_mb = mb * shape[0]
        reference = _grads(cfg, mode, None, ref_mb)
        sharded = _grads(cfg, mode, shape, mb)

        def share(a, b):
            tol = max(CS.PARITY_GRAD_RTOL * float(b.abs().max()), 1e-30)
            return float((a - b).abs().max()) / tol
        rows = []
        for k, ref in first.items():
            row = dict(leaf=k, largest=float(ref.abs().max()),
                       sharded=share(sharded[k], ref),
                       repeat=share(again[k], ref),
                       rows=share(reference[k], ref),
                       sharded_vs_reference=share(sharded[k], reference[k]))
            if ref.dim() == 0:
                row.update(values=[float(g[k]) for g in (first, again,
                                                         reference, sharded)],
                           sharded_held=float((sharded[k] - ref).abs())
                           / CS._grad_tolerance(ref, float(
                               (reference[k] - ref).abs())))
            rows.append(row)
        print(json.dumps(dict(
            arm=tag, mesh=shape, reference_microbatches=ref_mb,
            leaves=len(rows),
            worst_sharded=sorted(rows, key=lambda r: -r["sharded"])[:10],
            worst_repeat=sorted(rows, key=lambda r: -r["repeat"])[:10],
            worst_vs_reference=sorted(
                rows, key=lambda r: -r["sharded_vs_reference"])[:10],
            scalars=[r for r in rows if "values" in r])), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["vlm_2x2"])
