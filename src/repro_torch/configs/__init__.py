"""Port of repro/configs/__init__.py.

Config registry: ``get_config(arch)`` / ``ARCHS``. Ported so far: the dense
architectures (the three paged-capable ones and the sliding-window
h2o-danube-3-4b, served from the lanes layout), the two MoE ones, the SSM
mamba2-130m, the hybrid zamba2-2.7b and the encoder-decoder whisper-medium
(all lanes layout). Still missing: the VLM llama-3.2-vision-90b; asking for
it raises ``NotImplementedError``. ``PAPER_WORKLOAD`` / ``FIG3_CLAIMS`` are the
paper's section 4 experiment, which is not a model.
"""
from __future__ import annotations

from typing import Dict

from .base import DENSE, ENCDEC, HYBRID, MOE, SSM, VLM, ModelConfig
from .granite_moe_3b_a800m import CONFIG as _granite
from .h2o_danube_3_4b import CONFIG as _h2o
from .mamba2_130m import CONFIG as _mamba2
from .nemotron_4_15b import CONFIG as _nemotron
from .paper_urdma import FIG3_CLAIMS, PAPER_WORKLOAD, PaperWorkload
from .qwen2_7b import CONFIG as _qwen2
from .qwen3_moe_235b_a22b import CONFIG as _qwen3moe
from .stablelm_1_6b import CONFIG as _stablelm
from .whisper_medium import CONFIG as _whisper
from .zamba2_2_7b import CONFIG as _zamba2

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in (_h2o, _nemotron, _qwen2, _stablelm, _granite,
                        _qwen3moe, _mamba2, _zamba2, _whisper)
}

# the architecture the JAX package registers that this port does not have
# yet: the VLM
NOT_PORTED = ("llama-3.2-vision-90b",)


def get_config(arch: str) -> ModelConfig:
    """Look up a ported architecture by id (``--arch <id>``)."""
    if arch in ARCHS:
        return ARCHS[arch]
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"not ported yet: arch {arch!r} (ported: "
            f"{', '.join(sorted(ARCHS))})")
    raise KeyError(
        f"unknown arch {arch!r}; available: {', '.join(sorted(ARCHS))}")


__all__ = ["ARCHS", "NOT_PORTED", "ModelConfig", "get_config",
           "FIG3_CLAIMS", "PAPER_WORKLOAD", "PaperWorkload",
           "DENSE", "MOE", "SSM", "HYBRID", "ENCDEC", "VLM"]
