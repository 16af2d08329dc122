"""Port of repro/launch/train.py: ``python -m repro_torch.launch.train --arch
<id> [...]``.

Trains the architecture's model (the reduced variant unless ``--full``) on
the synthetic token stream with AdamW under a warmup-cosine schedule,
microbatching, checkpoints (every quarter of the run, with
``--checkpoint-dir``; a run resumes from the latest) and the Trainer's
fault tolerance, as the JAX launcher does. The stream carries tokens only:
the VLM trains with its cross layers over the text (its ``forward`` without
media, as the JAX launcher trains it), and whisper-medium, which takes
frames, refuses at its first step with the ``ValueError`` "takes media"
(the JAX launcher fails there with a ``KeyError``). Runs on the GPU unless
``--device cpu`` is given (no GPU: it raises). Where more than one device
is visible (distinct cards, or ``REPRO_TORCH_VIRTUAL_DEVICES`` virtual
ones on ``--device``), it takes the JAX launcher's multi-device branch: the
state placed on ``make_production_mesh()`` by ``state_shardings`` and the
sharded step, every family (whisper-medium then refuses at its first step
as on one device; too few devices for the mesh raise its ``ValueError``). The weights are drawn from seed 0 with
``torch.Generator`` (the JAX launcher's from ``jax.random.key(0)``).
"""
from __future__ import annotations

import argparse
import logging

import torch

from ..configs import get_config
from ..data import DataConfig, Pipeline, SyntheticSource
from ..models import build_model
from ..optim import AdamW, warmup_cosine
from ..train import (Trainer, TrainerConfig, init_train_state,
                     make_train_step, place_train_state)
from .mesh import make_production_mesh, visible_devices


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="CPU-scale config (the default)")
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--dispatch-mode", default="staged",
                    choices=("direct", "staged", "adaptive"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    kwargs = {"dispatch_mode": args.dispatch_mode} if cfg.n_experts else {}
    model = build_model(cfg, device=args.device, **kwargs)
    n_hot = max(1, cfg.n_experts // 4) if cfg.n_experts else 0

    opt = AdamW(lr=warmup_cosine(args.lr, max(args.steps // 20, 1), args.steps))
    mesh = None
    if visible_devices(args.device) > 1:
        mesh = make_production_mesh(device=args.device)
    state = init_train_state(model, opt, 0, n_hot)
    if mesh is not None:
        state = place_train_state(state, mesh)
    step = make_train_step(model, opt, microbatches=args.microbatches,
                           n_hot_experts=n_hot, mesh=mesh)

    dc = DataConfig(seq_len=args.seq, global_batch=args.batch, vocab=cfg.vocab)
    pipe = Pipeline(SyntheticSource(dc)).start()
    trainer = Trainer(step, state, pipe, TrainerConfig(
        total_steps=args.steps,
        checkpoint_every=max(args.steps // 4, 1),
        checkpoint_dir=args.checkpoint_dir,
    ))
    try:
        trainer.maybe_resume()
        result = trainer.run()
    finally:
        pipe.stop()
    print(f"done: {result}")
    return result


if __name__ == "__main__":
    main()
