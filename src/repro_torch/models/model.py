"""Port of repro/models/model.py: ``build_model(cfg, device)`` for the dense
family. The MoE, SSM, hybrid, encoder-decoder and VLM families are not
ported yet and raise ``NotImplementedError``. The model lives on the GPU
unless the caller asks for ``device="cpu"``."""
from __future__ import annotations

from ..configs.base import DENSE, ModelConfig
from .transformer import DecoderLM


def build_model(cfg: ModelConfig, device="cuda") -> DecoderLM:
    """Family dispatch; ``device="cuda"`` without CUDA raises."""
    if cfg.family != DENSE:
        raise NotImplementedError(
            f"not ported yet: model family {cfg.family!r} ({cfg.name}); "
            f"the dense family only")
    return DecoderLM(cfg, device=device)
