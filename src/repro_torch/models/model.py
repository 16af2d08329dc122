"""Port of repro/models/model.py: ``build_model(cfg, device, **kwargs)``,
the family dispatch: dense -> ``DecoderLM``, moe -> ``MoELM``
(``dispatch_mode``, staged by default), ssm -> ``MambaLM``, hybrid ->
``ZambaLM``. The encoder-decoder and VLM families are not ported yet and
raise ``NotImplementedError``. The model lives on the GPU unless the caller
asks for ``device="cpu"``."""
from __future__ import annotations

from ..configs.base import DENSE, HYBRID, MOE, SSM, ModelConfig
from .moe_lm import MoELM
from .ssm_lm import MambaLM, ZambaLM
from .transformer import DecoderLM

_FAMILIES = {DENSE: DecoderLM, MOE: MoELM, SSM: MambaLM, HYBRID: ZambaLM}


def build_model(cfg: ModelConfig, device="cuda", **kwargs):
    """Family dispatch; kwargs go to the family's class (e.g.
    ``dispatch_mode`` for MoE). ``device="cuda"`` without CUDA raises."""
    cls = _FAMILIES.get(cfg.family)
    if cls is None:
        raise NotImplementedError(
            f"not ported yet: model family {cfg.family!r} ({cfg.name}); "
            f"the encdec and vlm families are still missing")
    return cls(cfg, device=device, **kwargs)
