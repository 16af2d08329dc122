"""Port of repro/serve/__init__.py: the serving layer.

* :class:`Engine` / :class:`EngineConfig`: THE front door, with per-request
  ``SamplingParams``, ``generate``/``stream`` returning :class:`Completion`
  objects, write path + routing policy chosen by registry name, and an
  explicit ``device``.
* :class:`MemoryConfig` / :class:`AttentionConfig` / :class:`ParallelConfig`
  / :class:`SpecConfig`: the grouped sub-configs (``SpecConfig``:
  speculative decoding, draft-then-verify as a third execution path).
* ``ServeEngine`` / ``BatchedServeEngine``: the internal engines (the
  per-request engine over the dense lanes cache with its staging ring, and
  the continuous-batching scheduler); direct construction raises
  ``TypeError``: build engines through ``Engine.from_config``
  (``ServeEngine`` with ``_internal=True``, as the JAX package's
  benchmarks and tests do). ``WRITE_MODES`` / ``ServeConfig`` /
  ``make_decision`` go with ``ServeEngine``.
"""
from ..models.sampling import SamplingParams
from .api import (AttentionConfig, Completion, Engine, EngineConfig,
                  MemoryConfig, ParallelConfig, SpecConfig, StreamEvent,
                  build_model_and_params)
from .engine import WRITE_MODES, ServeConfig, ServeEngine, make_decision
from .scheduler import BatchConfig, BatchedServeEngine, SlotState, make_slots

__all__ = [
    "Engine", "EngineConfig", "MemoryConfig", "AttentionConfig",
    "ParallelConfig", "SpecConfig",
    "Completion", "SamplingParams", "StreamEvent", "build_model_and_params",
    "WRITE_MODES", "ServeConfig", "ServeEngine", "make_decision",
    "BatchConfig", "BatchedServeEngine", "SlotState", "make_slots",
]
