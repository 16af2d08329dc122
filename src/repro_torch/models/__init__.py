"""Port of repro/models/__init__.py: the dense, MoE, SSM and hybrid
decoders and the sampler."""
from .model import build_model
from .moe_lm import MoELM
from .sampling import SamplingParams
from .ssm_lm import MambaLM, ZambaLM
from .transformer import DecoderLM

__all__ = ["DecoderLM", "MambaLM", "MoELM", "SamplingParams", "ZambaLM",
           "build_model"]
