"""Port of repro/models/__init__.py: the dense and MoE decoders and the
sampler."""
from .model import build_model
from .moe_lm import MoELM
from .sampling import SamplingParams
from .transformer import DecoderLM

__all__ = ["DecoderLM", "MoELM", "SamplingParams", "build_model"]
