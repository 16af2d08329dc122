#!/usr/bin/env python3
"""Two checkouts' K3 backward against each other, on one GPU, and their K3
forwards held to the same bits.

Runs checkout A, then B, B and A, each in a process of its own, so that both
are timed in turns on the same card. Each run builds its checkout's kernels
and, through that checkout's ``chip_smoke.py``, times ``flash_attention_bwd``
at the training phases' two microbatches (stablelm-1.6b ``q[4,32,512,64]``
and granite-moe-3b-a800m ``q[4,24,512,64]`` over 8 KV heads, bf16, causal,
strided views of ``[B, S, H, D]``, from K3's own ``out`` and ``lse``): the
device ms from the profiler's trace (mean of 20 calls), the CUDA-event ms of
one call, a SHA-256 of its outputs and, where the checkout's
``chip_smoke.py`` has it, the split among the backward's launches. It also hashes K3's forward outputs (with and
without ``lse``, bf16 and fp32) at shapes covering head_dim 64, 80, 120 and
128, GQA, a window, S < T, a non-causal read and ragged edges: the hashes
must agree between the runs.

    python3 tools/ab_k3_bwd.py A_DIR B_DIR

Each directory is the root of a checkout, for example a ``git archive`` of
the parent commit unpacked into a git-ignored directory. Needs a CUDA
device and ``nvcc``. The last line of the output is one JSON object with
every run; the exit code is 1 when the forwards' bits differ.
"""
import hashlib
import json
import os
import subprocess
import sys

import torch

# b, hq, hkv, s, t, d, causal, window
FORWARD_SHAPES = ((2, 8, 8, 300, 300, 64, True, 0),
                  (1, 8, 2, 200, 520, 80, True, 0),
                  (1, 4, 1, 700, 700, 120, True, 256),
                  (1, 16, 2, 333, 333, 128, True, 0),
                  (1, 16, 2, 64, 1601, 128, False, 0),
                  (2, 4, 4, 37, 37, 64, True, 0))


def _digest(*xs):
    """SHA-256 of the tensors' bytes."""
    h = hashlib.sha256()
    for x in xs:
        h.update(x.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def one(root, tag):
    """Run in a child process: ``root``'s K3 forward and backward."""
    sys.path.insert(0, root)
    import chip_smoke as cs

    assert os.path.dirname(os.path.abspath(cs.__file__)) == root, cs.__file__
    card = cs.phase_env()
    cs.phase_build()
    forward = {}
    for i, case in enumerate(FORWARD_SHAPES):
        b, hq, hkv, s, t, d, causal, w = case
        for dtype in (torch.bfloat16, torch.float32):
            gen = cs.timed_gen(300 + i)
            q, k, v = cs._k3_inputs(gen, dtype, b, hq, hkv, s, t, d)
            o = cs.flash_attention(q, k, v, causal, w)
            o2, lse = cs.flash_attention_lse(q, k, v, causal, w)
            torch.cuda.synchronize()
            forward[f"{case} {dtype}"] = _digest(o, o2, lse)
    backward = {}
    for name, case, seed in (("stablelm", cs.K3_BWD_CASES[0], 180),
                             ("granite", cs.K3_BWD_CASES[1], 181)):
        _, _, _, _, _, _, causal, w = case
        q, k, v, do = cs._k3_bwd_inputs(cs.timed_gen(seed), case,
                                        torch.bfloat16)
        o, lse = cs.flash_attention_lse(q, k, v, causal, w)
        fn = lambda: cs.flash_attention_bwd(q, k, v, o, lse, do, causal, w)  # noqa: E731
        row = dict(case=list(case), digest=_digest(*fn()),
                   ms=cs.device_ms(fn, f"{tag} flash_attention_bwd {name}"),
                   event_ms=cs.time_ms(fn))
        if hasattr(cs, "k3_bwd_sub_kernels"):
            row["sub_kernels"] = cs.k3_bwd_sub_kernels(
                fn, f"{tag} flash_attention_bwd {name} sub-kernels")
        backward[name] = row
    print(json.dumps(dict(tag=tag, root=root, card=card, backward=backward,
                          forward=forward)), flush=True)


def main():
    if sys.argv[1] == "--one":
        return one(os.path.abspath(sys.argv[2]), sys.argv[3])
    a, b = (os.path.abspath(d) for d in sys.argv[1:3])
    runs = []
    for root, tag in ((a, "A1"), (b, "B1"), (b, "B2"), (a, "A2")):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root, tag],
            capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f"{tag} ({root}) failed:\n{proc.stdout[-4000:]}\n"
                     f"{proc.stderr[-8000:]}")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(run)
        for name, t in run["backward"].items():
            print(tag, "flash_attention_bwd", name, "ms", t["ms"], "event_ms",
                  t["event_ms"], "digest", t["digest"], "sub_kernels",
                  t.get("sub_kernels"), flush=True)
    same = all(r["forward"] == runs[0]["forward"] for r in runs)
    print(json.dumps(dict(runs=runs, forward_bits_agree=same)), flush=True)
    if not same:
        sys.exit("K3's forward outputs differ between the runs")


if __name__ == "__main__":
    main()
