"""Port of repro/serve/__init__.py: the serving layer.

* :class:`Engine` / :class:`EngineConfig`: THE front door, with per-request
  ``SamplingParams``, ``generate``/``stream`` returning :class:`Completion`
  objects, write path + routing policy chosen by registry name, and an
  explicit ``device``.
* :class:`MemoryConfig` / :class:`AttentionConfig`: the grouped sub-configs.
* ``BatchedServeEngine``: the internal scheduler; build engines through
  ``Engine.from_config``.
"""
from ..models.sampling import SamplingParams
from .api import (AttentionConfig, Completion, Engine, EngineConfig,
                  MemoryConfig, StreamEvent, build_model_and_params)
from .scheduler import BatchConfig, BatchedServeEngine, SlotState, make_slots

__all__ = [
    "Engine", "EngineConfig", "MemoryConfig", "AttentionConfig",
    "Completion", "SamplingParams", "StreamEvent", "build_model_and_params",
    "BatchConfig", "BatchedServeEngine", "SlotState", "make_slots",
]
