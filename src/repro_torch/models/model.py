"""Port of repro/models/model.py: ``build_model(cfg, device, **kwargs)``,
the family dispatch: dense and vlm -> ``DecoderLM`` (the VLM's gated cross
layers when ``cross_attn_every > 0``), moe -> ``MoELM`` (``dispatch_mode``,
staged by default), ssm -> ``MambaLM``, hybrid -> ``ZambaLM``, encdec ->
``WhisperModel``; and ``media_spec`` / ``needs_media``, which say which
families take media and in what shape. The model lives on the GPU unless
the caller asks for ``device="cpu"``."""
from __future__ import annotations

from typing import Tuple

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
