"""Port of repro/models/model.py: ``build_model(cfg, device, **kwargs)``,
the family dispatch: dense and vlm -> ``DecoderLM`` (the VLM's gated cross
layers when ``cross_attn_every > 0``), moe -> ``MoELM`` (``dispatch_mode``,
staged by default), ssm -> ``MambaLM``, hybrid -> ``ZambaLM``, encdec ->
``WhisperModel``; ``media_spec`` / ``needs_media``, which say which
families take media and in what shape; ``input_specs`` / ``abstract_params``,
the abstract inputs and parameters of a dry-run cell (``ShapeDtypeStruct``
trees in the JAX package's layout, built on the ``meta`` device: no weight
drawn, nothing allocated); ``trunk_parts``, how each family
nests its layers under remat, and ``remat_calls``, the attention and SSD
calls a remat train step makes. The model lives on the GPU unless
the caller asks for ``device="cpu"``."""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..configs.base import (DENSE, ENCDEC, HYBRID, MOE, SSM, VLM, ModelConfig,
                            ShapeSpec)
from .moe_lm import MoELM
from .ssm_lm import MambaLM, ZambaLM
from .transformer import DecoderLM
from .whisper import WhisperModel

_FAMILIES = {DENSE: DecoderLM, VLM: DecoderLM, MOE: MoELM, SSM: MambaLM,
             HYBRID: ZambaLM, ENCDEC: WhisperModel}


def build_model(cfg: ModelConfig, device="cuda", max_seq: int = 0,
                **kwargs):
    """Family dispatch; kwargs go to the family's class (e.g.
    ``dispatch_mode`` for MoE). ``max_seq`` sizes whisper's learned decoder
    positions (``max(cfg.max_position, max_seq)`` rows, as the reference's
    ``init(key, max_seq)``); no other family reads it. ``device="cuda"``
    without CUDA raises."""
    cls = _FAMILIES.get(cfg.family)
    if cls is None:
        raise ValueError(f"unknown model family {cfg.family!r} ({cfg.name})")
    if cls is WhisperModel:
        kwargs["max_seq"] = max_seq
    return cls(cfg, device=device, **kwargs)


def media_spec(cfg: ModelConfig, batch: int) -> Tuple[int, int, int]:
    """The shape of a batch's stub frontend embeddings: VLM patch tokens /
    whisper audio frames (the reference returns a ``ShapeDtypeStruct``)."""
    if cfg.family == VLM:
        return (batch, cfg.n_image_tokens, cfg.d_model)
    if cfg.family == ENCDEC:
        return (batch, cfg.n_audio_frames, cfg.d_model)
    raise ValueError(f"{cfg.name} has no media input")


def needs_media(cfg: ModelConfig) -> bool:
    return cfg.family in (VLM, ENCDEC)


def _spec(t) -> Any:
    from ..distributed.sharding import ShapeDtypeStruct
    return ShapeDtypeStruct(tuple(t.shape), t.dtype)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Abstract inputs of one dry-run cell (``ShapeDtypeStruct``s, no
    allocation), keyed as the JAX package keys them.

    train:   {tokens, labels[, media]}
    prefill: {tokens[, media]}
    decode:  {tokens [B], pos [B], cache (the family's cache tree)}
    """
    from ..distributed.sharding import ShapeDtypeStruct
    from .transformer import compute_dtype

    dtype = compute_dtype(cfg)
    b, s = shape.global_batch, shape.seq_len
    tok = ShapeDtypeStruct((b, s), torch.int32)
    if shape.step in ("train", "prefill"):
        specs = {"tokens": tok}
        if shape.step == "train":
            specs["labels"] = ShapeDtypeStruct((b, s), torch.int32)
        if needs_media(cfg):
            specs["media"] = ShapeDtypeStruct(media_spec(cfg, b), dtype)
        return specs
    if shape.step == "decode":
        model = build_model(cfg, device="meta", max_seq=s)
        cache = model.init_cache(b, s, dtype)
        return {"tokens": ShapeDtypeStruct((b,), torch.int32),
                "pos": ShapeDtypeStruct((b,), torch.int32),
                "cache": {k: _spec(v) for k, v in cache.items()}}
    raise ValueError(shape.step)


def abstract_params(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """The parameters of a cell as a ``ShapeDtypeStruct`` tree in the JAX
    layout (``models.layout.jax_tree``: a stack's layers on a leading
    axis), from a model built on ``meta`` (whisper's decoder positions
    sized by ``max_seq = shape.seq_len``)."""
    from ..distributed.sharding import ShapeDtypeStruct
    from .layout import jax_tree

    model = build_model(cfg, device="meta", max_seq=shape.seq_len)

    def leaf(values, stacked):
        one = values[0]
        return ShapeDtypeStruct(((len(values),) if stacked else ())
                                + tuple(one.shape), one.dtype)
    return jax_tree(model.named_parameters(), leaf)


class TrunkPart(NamedTuple):
    """One kind of layer in a family's trunk, as a remat train step runs a
    microbatch through it: its parameters' prefix (``blocks``, ``shared``,
    ...), its applications, the checkpoints around each (1, or 2 for a
    layer checkpointed inside a checkpointed group), the sums it makes in
    order (``attn``: a self read on K3; ``cross``: a K3 read of whisper's
    encoder output; ``mlp``, ``moe``, ``ssd``), whether a gate scales its
    outputs, and whether it runs over the audio frames (whisper's
    encoder)."""
    stack: str
    count: int
    depth: int
    ops: Tuple[str, ...]
    gated: bool = False
    frames: bool = False


def trunk_parts(cfg: ModelConfig) -> Tuple[TrunkPart, ...]:
    """How ``cfg``'s family nests its trunk under remat: zamba2's mamba
    layers nested in the G = L / every groups, the shared block under the
    group's checkpoint only; whisper's encoder layers and decoder layers
    (self read, cross read, MLP) under one checkpoint each; the VLM's self
    layers nested in the G groups, the gated cross layer under the group's
    checkpoint (with or without media); every other layer under one."""
    n = cfg.n_layers
    if cfg.family == SSM:
        return (TrunkPart("blocks", n, 1, ("ssd",)),)
    if cfg.family == HYBRID:
        return (TrunkPart("blocks", n, 2, ("ssd",)),
                TrunkPart("shared", n // cfg.hybrid_attn_every, 1,
                          ("attn", "mlp")))
    if cfg.family == ENCDEC:
        return (TrunkPart("enc_blocks", cfg.n_enc_layers, 1, ("attn", "mlp"),
                          frames=True),
                TrunkPart("dec_blocks", n, 1, ("attn", "cross", "mlp")))
    if cfg.family == VLM:
        g = n // cfg.cross_attn_every
        return (TrunkPart("blocks", n - g, 2, ("attn", "mlp")),
                TrunkPart("cross_blocks", g, 1, ("attn", "mlp"), gated=True))
    return (TrunkPart("blocks", n, 1,
                      ("attn", "moe" if cfg.family == MOE else "mlp")),)


def remat_calls(cfg: ModelConfig) -> Dict[str, int]:
    """The calls one microbatch of a remat train step (``loss(remat=True)``
    and its backward) makes of K3's forward (``flash_attention``), its
    backward (``flash_attention_bwd``) and the SSD (``ssd_chunked``), from
    ``trunk_parts``: a layer runs once and again in the recompute of each
    checkpoint around it, a backward once."""
    fwd = bwd = ssd = 0
    for p in trunk_parts(cfg):
        runs = p.count * (p.depth + 1)
        reads = sum(op in ("attn", "cross") for op in p.ops)
        fwd, bwd = fwd + runs * reads, bwd + p.count * reads
        ssd += runs * ("ssd" in p.ops)
    return dict(flash_attention=fwd, flash_attention_bwd=bwd, ssd_chunked=ssd)
