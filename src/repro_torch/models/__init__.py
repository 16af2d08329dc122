"""Port of repro/models/__init__.py: the dense, MoE, SSM, hybrid and
encoder-decoder models, the media helpers and the sampler."""
from .model import (TrunkPart, build_model, media_spec, needs_media,
                    remat_calls, trunk_parts)
from .moe_lm import MoELM
from .sampling import SamplingParams
from .ssm_lm import MambaLM, ZambaLM
from .transformer import DecoderLM
from .whisper import WhisperModel

__all__ = ["DecoderLM", "MambaLM", "MoELM", "SamplingParams", "TrunkPart",
           "WhisperModel", "ZambaLM", "build_model", "media_spec",
           "needs_media", "remat_calls", "trunk_parts"]
