"""Port of repro/launch/cells.py: the dry-run cells, (arch x shape) ->
(step_fn, args, meta).

Shared by ``launch.dryrun`` (memory fit on both production meshes) and
``launch.roofline`` (the depth probes' operation, byte and collective
counts). Everything lives on the ``meta`` device: the model's masters, the
placed train state, the batch and the caches are ``meta`` tensors, the mesh
an abstract one (``make_production_mesh(device="meta")``), and the kernel
wrappers shape their outputs and count their cost without launching
(``kernels.cost``). Nothing here allocates memory or draws a weight.

Step kinds:
  train    -> the sharded ``make_train_step(..., mesh=)`` (grad-accum
              microbatches, remat, AdamW; FSDP over ``data``, Megatron and
              expert parallelism over ``model``, the vocab-parallel loss)
  prefill  -> ``models.parallel.sharded_chunk_prefill`` of the LAST chunk
              (its queries read the full 32k cache), under the training
              parameter shardings
  decode   -> ``models.parallel.sharded_decode_step`` (one new token
              against a seq_len KV cache), likewise

Serving cells are built for the dense family; the other families' serving
cells and every ``long_500k`` cell raise ``NotImplementedError`` naming
their ROADMAP.md item.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import DENSE, ModelConfig, ShapeSpec
from ..distributed.sharding import (axis_size, batch_pspec, cache_pspec,
                                    entry_axes, param_pspec,
                                    tree_paths_and_leaves)
from ..models import parallel
from ..models.model import abstract_params, build_model, input_specs
from ..optim import AdamW, warmup_cosine
from ..train import init_train_state, make_train_step
from ..train.trainer import place_train_state

# per-arch microbatch count for the train_4k cell (global batch 256), as
# the JAX package sets them
TRAIN_MICROBATCHES = {
    "default": 8,
    "qwen2-7b": 16,
    "granite-moe-3b-a800m": 16,
    "qwen3-moe-235b-a22b": 16,
    "llama-3.2-vision-90b": 16,
    "nemotron-4-15b": 16,
    "whisper-medium": 16,
    "zamba2-2.7b": 16,
}

# chunk size for the prefill cells, as the JAX package sets them
PREFILL_CHUNK = {
    "default": 1024,
    "qwen2-7b": 512,
}

# what the serving cells not built yet wait for (ROADMAP.md, Queue A 3)
SERVE_TODO = ("ROADMAP.md Queue A 3a: serving dry-run cells (per-rank "
              "decode_step / chunk_prefill under FSDP + TP) for the {family} "
              "family")
LONG_TODO = ("ROADMAP.md Queue A 3b: long_500k needs a sequence-sharded "
             "decode with a log-sum-exp merge across ranks")


def prefill_chunk(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """The tokens of a prefill cell's chunk."""
    return min(PREFILL_CHUNK.get(cfg.name, PREFILL_CHUNK["default"]),
               shape.seq_len)


def _n_hot(cfg: ModelConfig) -> int:
    return max(1, cfg.n_experts // 4) if cfg.n_experts else 0


def make_optimizer(total_steps: int = 10_000) -> AdamW:
    return AdamW(lr=warmup_cosine(3e-4, 200, total_steps))


def meta_tensors(specs: Any) -> Any:
    """A ``{key: ShapeDtypeStruct}`` tree (one level of nesting at most)
    as ``meta`` tensors."""
    def one(v):
        return torch.empty(v.shape, dtype=v.dtype, device="meta")
    return {k: ({kk: one(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else one(v)) for k, v in specs.items()}


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
               microbatches: Optional[int] = None,
               dispatch_mode: str = "staged") -> Tuple[Any, Tuple, Dict]:
    """-> (step_fn, args of ``meta`` tensors, meta). ``mesh`` is an
    abstract mesh (every device ``meta``)."""
    kwargs = {"dispatch_mode": dispatch_mode} if cfg.n_experts else {}
    meta: Dict[str, Any] = {"arch": cfg.name, "shape": shape.name,
                            "step": shape.step}
    if shape.name == "long_500k":
        raise NotImplementedError(LONG_TODO)
    if shape.step != "train" and cfg.family != DENSE:
        raise NotImplementedError(SERVE_TODO.format(family=cfg.family))
    model = build_model(cfg, device="meta", max_seq=shape.seq_len, **kwargs)
    specs = input_specs(cfg, shape)

    if shape.step == "train":
        mb = microbatches or TRAIN_MICROBATCHES.get(
            cfg.name, TRAIN_MICROBATCHES["default"])
        meta["microbatches"] = mb
        opt = make_optimizer()
        state = place_train_state(
            init_train_state(model, opt, seed=None,
                             n_hot_experts=_n_hot(cfg)), mesh)
        step = make_train_step(model, opt, microbatches=mb, remat=True,
                               n_hot_experts=_n_hot(cfg), mesh=mesh)
        return step, (state, meta_tensors(specs)), meta

    plan = parallel.ServePlan(model, mesh)
    meta["attention_scheme"] = plan.scheme
    if shape.step == "prefill":
        chunk = meta["chunk"] = prefill_chunk(cfg, shape)
        start = shape.seq_len - chunk      # the last chunk: the worst case
        b = shape.global_batch
        cache = plan.place_cache(meta_tensors(
            input_specs(cfg, dataclasses.replace(shape, step="decode"))
        )["cache"])
        tokens = torch.empty((b, chunk), dtype=torch.int32, device="meta")

        def step(cache, tokens):
            return parallel.sharded_chunk_prefill(plan, cache, tokens, start)
        return step, (cache, tokens), meta

    if shape.step == "decode":
        args = meta_tensors(specs)
        cache = plan.place_cache(args["cache"])

        def step(cache, tokens, pos):
            return parallel.sharded_decode_step(plan, cache, tokens, pos)
        return step, (cache, args["tokens"], args["pos"]), meta

    raise ValueError(shape.step)


def _local_bytes(leaf, spec, mesh) -> int:
    """Bytes of one device's piece of ``leaf`` placed by ``spec``."""
    n = torch.empty((), dtype=leaf.dtype).element_size()
    for d, e in zip(leaf.shape, spec):
        n *= d // axis_size(mesh, *entry_axes(e))
    return n


def resident_bytes(cfg: ModelConfig, shape: ShapeSpec, mesh) -> Dict[str, int]:
    """Per-device bytes a cell holds before its step runs, from the specs
    and shapes alone (no tensor made): train, the fp32 masters, both AdamW
    moments and the batch; serving, the masters, the KV cache (placed as
    ``models.parallel.ServePlan`` places it) and the step's tokens."""
    params = abstract_params(cfg, shape)
    p = sum(_local_bytes(v, param_pspec(cfg, mesh, k, v.shape), mesh)
            for k, v in tree_paths_and_leaves(params))
    if shape.step == "train":
        batch = sum(_local_bytes(v, batch_pspec(cfg, mesh, k, v.shape), mesh)
                    for k, v in tree_paths_and_leaves(input_specs(cfg, shape)))
        return {"params": p, "opt_state": 2 * p, "batch": batch}
    specs = input_specs(cfg, dataclasses.replace(shape, step="decode"))
    b = shape.global_batch
    if shape.step == "prefill":
        toks = {"tokens": torch.empty((b, prefill_chunk(cfg, shape)),
                                      dtype=torch.int32, device="meta")}
    else:
        toks = {k: specs[k] for k in ("tokens", "pos")}
    batch = sum(_local_bytes(v, batch_pspec(cfg, mesh, k, v.shape), mesh)
                for k, v in toks.items())
    plan = parallel.MeshPlan(build_model(cfg, device="meta",
                                         max_seq=shape.seq_len), mesh)
    cache = 0
    for k, v in specs["cache"].items():
        spec = cache_pspec(cfg, mesh, k, v.shape)
        if plan.scheme != "heads":
            # the kv heads each rank's q heads read, over the dp axes
            heads = max(len(h) for h in plan.kv_heads)
            spec = (None, spec[1], None, None, None)
            v = type(v)(v.shape[:3] + (heads,) + v.shape[4:], v.dtype)
        cache += _local_bytes(v, spec, mesh)
    return {"params": p, "cache": cache, "batch": batch}


def depth_probes(cfg: ModelConfig) -> list:
    """Depth knobs for the affine roofline probes (see launch/roofline.py).

    Returns a list of (label, replace_kwargs, depth_value) — cost is affine
    in each depth knob; two probes give base + marginal.
    """
    if cfg.family == "vlm":
        g = cfg.cross_attn_every
        return [("d", {"n_layers": g}, 1), ("d", {"n_layers": 2 * g}, 2)]
    if cfg.family == "hybrid":
        g = cfg.hybrid_attn_every
        return [("d", {"n_layers": g}, 1), ("d", {"n_layers": 2 * g}, 2)]
    if cfg.family == "encdec":
        return [
            ("d", {"n_layers": 1, "n_enc_layers": 1}, (1, 1)),
            ("d", {"n_layers": 2, "n_enc_layers": 1}, (2, 1)),
            ("enc", {"n_layers": 1, "n_enc_layers": 2}, (1, 2)),
        ]
    return [("d", {"n_layers": 1}, 1), ("d", {"n_layers": 2}, 2)]


def probe_config(cfg: ModelConfig, replace_kwargs: dict) -> ModelConfig:
    return dataclasses.replace(cfg, **replace_kwargs)


def full_depth_units(cfg: ModelConfig):
    """How many 'depth units' the full config has, matching depth_probes."""
    if cfg.family == "vlm":
        return cfg.n_layers // cfg.cross_attn_every
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_attn_every
    if cfg.family == "encdec":
        return (cfg.n_layers, cfg.n_enc_layers)
    return cfg.n_layers


__all__ = ["LONG_TODO", "PREFILL_CHUNK", "SERVE_TODO", "TRAIN_MICROBATCHES",
           "build_cell", "depth_probes", "full_depth_units", "make_optimizer",
           "meta_tensors", "prefill_chunk", "probe_config",
           "resident_bytes"]
