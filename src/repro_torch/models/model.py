"""Port of repro/models/model.py: ``build_model(cfg, device, **kwargs)``,
the family dispatch: dense and vlm -> ``DecoderLM`` (the VLM's gated cross
layers when ``cross_attn_every > 0``), moe -> ``MoELM`` (``dispatch_mode``,
staged by default), ssm -> ``MambaLM``, hybrid -> ``ZambaLM``, encdec ->
``WhisperModel``; ``media_spec`` / ``needs_media``, which say which
families take media and in what shape; and ``remat_calls``, the attention
and SSD calls a remat train step makes. The model lives on the GPU unless
the caller asks for ``device="cpu"``."""
from __future__ import annotations

from typing import Dict, Tuple

from ..configs.base import DENSE, ENCDEC, HYBRID, MOE, SSM, VLM, ModelConfig
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


def remat_calls(cfg: ModelConfig) -> Dict[str, int]:
    """The calls one microbatch of a remat train step (``loss(remat=True)``
    and its backward) makes of K3's forward (``flash_attention``), its
    backward (``flash_attention_bwd``) and the SSD (``ssd_chunked``). A
    layer under one checkpoint runs twice (the forward, its recompute), a
    layer checkpointed inside a checkpointed group three times (the
    forward, the group's recompute, its own), a backward once:

    * dense and MoE: K3 2 L / L;
    * mamba2: the SSD 2 L, no attention;
    * zamba2 (its mamba layers nested in the G = L / every groups, the
      shared block under the group's checkpoint only): K3 2 G / G, the
      SSD 3 L;
    * whisper (its encoder's self-attention and its decoder's self and
      cross reads under one checkpoint each): K3 2 C / C for
      C = L_enc + 2 L;
    * the VLM (its self layers nested in the G groups, the cross layer
      under the group's checkpoint, with or without media): K3
      3 L_self + 2 G / L_self + G."""
    fwd = bwd = ssd = 0
    if cfg.family == SSM:
        ssd = 2 * cfg.n_layers
    elif cfg.family == HYBRID:
        g = cfg.n_layers // cfg.hybrid_attn_every
        fwd, bwd, ssd = 2 * g, g, 3 * cfg.n_layers
    elif cfg.family == ENCDEC:
        c = cfg.n_enc_layers + 2 * cfg.n_layers
        fwd, bwd = 2 * c, c
    elif cfg.family == VLM:
        g = cfg.n_layers // cfg.cross_attn_every
        n_self = cfg.n_layers - g
        fwd, bwd = 3 * n_self + 2 * g, n_self + g
    else:
        fwd, bwd = 2 * cfg.n_layers, cfg.n_layers
    return dict(flash_attention=fwd, flash_attention_bwd=bwd, ssd_chunked=ssd)
