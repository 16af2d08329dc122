"""Port of repro/launch/serve.py: ``python -m repro_torch.launch.serve
--arch <id> [...]``.

One front door (``repro_torch.serve.Engine``), two workload shapes:

* default: serve ``--batch`` same-length prompts concurrently (one slot per
  prompt) and report throughput.
* ``--batched``: continuous batching, a stream of ``--requests`` synthetic
  requests admitted FIFO into ``--slots`` serving slots, decoded in segments
  with stop/max-len retirement between them. ``--chunked`` admits at once
  and prefills in ``--chunk-size``-token chunks inside the segments (paged;
  chunk by chunk at admission on the lanes layout).

Sampling is per-request ``SamplingParams``: ``--temperature`` (default
greedy), ``--top-k``, ``--top-p`` and ``--seed`` (a per-request seed; the
weights' seed is ``--init-seed``). Runs on the GPU unless ``--device cpu``
is given (no GPU: it raises).
``--full-width`` serves the architecture at its published widths instead of
the reduced test variant. An architecture the paged pool cannot serve (the
sliding-window h2o-danube-3-4b, and the MoE granite-moe-3b-a800m and
qwen3-moe-235b-a22b, whose expert dispatch is staged and drains through
K1) runs on the lanes layout, which is direct-only: ``--write-mode`` is
downgraded to ``direct`` with a message.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..data import synthetic_requests
from ..models.sampling import SamplingParams
from ..serve import Engine, EngineConfig, build_model_and_params
from ..serve.scheduler import paged_capable


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--full-width", action="store_true",
                    help="published widths instead of the reduced variant")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--write-mode", "--path", dest="path", default="adaptive",
                    help="registered WritePath name (direct/staged/adaptive)")
    ap.add_argument("--policy", default=None,
                    help="registered RoutingPolicy name (default: the "
                         "path's default policy)")
    ap.add_argument("--attention", default="auto",
                    help="auto | fused | reference")
    ap.add_argument("--temperature", type=float, default=None,
                    help="sampling temperature (default: greedy)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=None,
                    help="per-request sampling seed")
    ap.add_argument("--ring-size", type=int, default=8)
    ap.add_argument("--batched", action="store_true",
                    help="continuous batching over the paged KV pool (the "
                         "lanes layout for a sliding-window arch)")
    ap.add_argument("--requests", type=int, default=16,
                    help="(--batched) synthetic request count")
    ap.add_argument("--slots", type=int, default=8,
                    help="(--batched) serving slots")
    ap.add_argument("--segment-len", type=int, default=16,
                    help="(--batched) decode steps per segment")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--chunked", action="store_true",
                    help="(--batched) admit immediately, prefill prompts "
                         "in chunks inside the segments")
    ap.add_argument("--chunk-size", type=int, default=16,
                    help="(--chunked) prompt tokens per prefill chunk")
    ap.add_argument("--init-seed", type=int, default=0,
                    help="seed of the random weights")
    args = ap.parse_args(argv)

    cfg, model = build_model_and_params(
        args.arch, args.max_seq, seed=args.init_seed,
        reduced=not args.full_width, device=args.device)
    path = args.path
    if path != "direct" and not paged_capable(model):
        print(f"[serve] {cfg.name}: lanes layout is direct-only; "
              f"downgrading --write-mode {path} -> direct")
        path = "direct"
    sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p, seed=args.seed,
                        max_tokens=args.gen_len)
    common = dict(max_seq=args.max_seq, path=path, policy=args.policy,
                  page_size=args.page_size, ring_size=args.ring_size,
                  attention=args.attention, device=args.device)

    def sync():
        if torch.device(args.device).type == "cuda":
            torch.cuda.synchronize()

    if args.batched:
        queue = synthetic_requests(args.requests, args.prompt_len, cfg.vocab,
                                   args.gen_len, params=sp)
        eng = Engine.from_config(EngineConfig(
            n_slots=args.slots, segment_len=args.segment_len,
            chunked=args.chunked, chunk_size=args.chunk_size, **common),
            model)
        sync()
        t0 = time.perf_counter()
        outputs = eng.serve(queue)
        sync()
        dt = time.perf_counter() - t0
        n_toks = sum(len(t) for t in outputs.values())
        mode = f"{eng.layout}, chunked" if args.chunked else eng.layout
        print(f"[{mode}, {eng.attention}, {args.device}] served "
              f"{len(outputs)} requests / {n_toks} tokens in {dt:.2f}s "
              f"({n_toks / dt:.1f} tok/s)")
        if eng.ttft:
            ms = sorted(v * 1e3 for v in eng.ttft.values())
            print(f"ttft: mean {sum(ms) / len(ms):.1f} ms, "
                  f"max {ms[-1]:.1f} ms")
        print(f"write-path stats: {eng.stats}")
        return

    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab, size=args.prompt_len)
               for _ in range(args.batch)]
    eng = Engine.from_config(EngineConfig(n_slots=args.batch, **common),
                             model)
    sync()
    t0 = time.perf_counter()
    comps = eng.generate(prompts, sp)
    sync()
    dt = time.perf_counter() - t0
    n_toks = sum(c.n_tokens for c in comps)
    print(f"[{eng.layout}, {eng.attention}, {args.device}] generated "
          f"{len(comps)} x {args.gen_len} tokens in {dt:.2f}s "
          f"({n_toks / dt:.1f} tok/s)")
    print(f"write-path stats: {eng.stats}")


if __name__ == "__main__":
    main()
