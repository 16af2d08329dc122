"""Port of repro/configs/__init__.py.

Config registry: ``get_config(arch)`` / ``ARCHS``. The dense architectures
are ported so far: the three paged-capable ones and the sliding-window
h2o-danube-3-4b (served from the lanes layout); asking for another
architecture of the JAX package raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict

from .base import DENSE, ENCDEC, HYBRID, MOE, SSM, VLM, ModelConfig
from .h2o_danube_3_4b import CONFIG as _h2o
from .nemotron_4_15b import CONFIG as _nemotron
from .qwen2_7b import CONFIG as _qwen2
from .stablelm_1_6b import CONFIG as _stablelm

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in (_h2o, _nemotron, _qwen2, _stablelm)
}

# architectures the JAX package registers that this port does not have yet
NOT_PORTED = (
    "granite-moe-3b-a800m", "llama-3.2-vision-90b", "mamba2-130m",
    "qwen3-moe-235b-a22b", "whisper-medium", "zamba2-2.7b",
)


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
           "DENSE", "MOE", "SSM", "HYBRID", "ENCDEC", "VLM"]
