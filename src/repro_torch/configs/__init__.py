"""Port of repro/configs/__init__.py.

Config registry: ``get_config(arch)`` / ``ARCHS`` / shape specs
(``get_shape``, ``ALL_SHAPES``, ``shape_applicable``). Ported so far: the dense
architectures (the three paged-capable ones and the sliding-window
h2o-danube-3-4b, served from the lanes layout), the two MoE ones, the SSM
mamba2-130m, the hybrid zamba2-2.7b, the encoder-decoder whisper-medium and
the VLM llama-3.2-vision-90b (all lanes layout): every architecture the JAX
package registers. ``PAPER_WORKLOAD`` / ``FIG3_CLAIMS`` are the paper's
section 4 experiment, which is not a model.
"""
from __future__ import annotations

from typing import Dict

from .base import (ALL_SHAPES, DENSE, ENCDEC, HYBRID, MOE, SHAPES, SSM, VLM,
                   ModelConfig, ShapeSpec, shape_applicable)
from .granite_moe_3b_a800m import CONFIG as _granite
from .h2o_danube_3_4b import CONFIG as _h2o
from .llama_3_2_vision_90b import CONFIG as _llama_vision
from .mamba2_130m import CONFIG as _mamba2
from .nemotron_4_15b import CONFIG as _nemotron
from .paper_urdma import FIG3_CLAIMS, PAPER_WORKLOAD, PaperWorkload
from .qwen2_7b import CONFIG as _qwen2
from .qwen3_moe_235b_a22b import CONFIG as _qwen3moe
from .stablelm_1_6b import CONFIG as _stablelm
from .whisper_medium import CONFIG as _whisper
from .zamba2_2_7b import CONFIG as _zamba2

# in the JAX package's registry order (the dry-run report's row order)
ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in (_nemotron, _h2o, _qwen2, _stablelm, _granite,
                        _qwen3moe, _mamba2, _llama_vision, _whisper, _zamba2)
}

# architectures the JAX package registers that this port does not have yet:
# none
NOT_PORTED = ()


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


def get_shape(name: str) -> ShapeSpec:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {', '.join(SHAPES)}")
    return SHAPES[name]


__all__ = ["ARCHS", "ALL_SHAPES", "NOT_PORTED", "SHAPES", "ModelConfig",
           "ShapeSpec", "get_config", "get_shape", "shape_applicable",
           "FIG3_CLAIMS", "PAPER_WORKLOAD", "PaperWorkload",
           "DENSE", "MOE", "SSM", "HYBRID", "ENCDEC", "VLM"]
