"""Port of repro/models/model.py: ``build_model(cfg, device, **kwargs)``,
the family dispatch: dense -> ``DecoderLM``, moe -> ``MoELM``
(``dispatch_mode``, staged by default). The SSM, hybrid, encoder-decoder
and VLM families are not ported yet and raise ``NotImplementedError``. The
model lives on the GPU unless the caller asks for ``device="cpu"``."""
from __future__ import annotations

from ..configs.base import DENSE, MOE, ModelConfig
from .moe_lm import MoELM
from .transformer import DecoderLM


def build_model(cfg: ModelConfig, device="cuda", **kwargs) -> DecoderLM:
    """Family dispatch; kwargs go to the family's class (e.g.
    ``dispatch_mode`` for MoE). ``device="cuda"`` without CUDA raises."""
    if cfg.family == MOE:
        return MoELM(cfg, device=device, **kwargs)
    if cfg.family != DENSE:
        raise NotImplementedError(
            f"not ported yet: model family {cfg.family!r} ({cfg.name}); "
            f"the dense and MoE families only")
    return DecoderLM(cfg, device=device, **kwargs)
