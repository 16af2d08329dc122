"""Port of repro/models/__init__.py: the dense decoder and its sampler."""
from .model import build_model
from .sampling import SamplingParams
from .transformer import DecoderLM

__all__ = ["DecoderLM", "SamplingParams", "build_model"]
