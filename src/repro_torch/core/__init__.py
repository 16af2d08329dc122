"""Port of repro/core/__init__.py: the write plane (staging ring) and the
decision plane (monitor, policies, decision module, write-path registry)."""
from . import decision, monitor, paths, policy, ring, types
from .decision import DecisionModule
from .monitor import ExactMonitor, MonitorState
from .paths import (ADAPTIVE, DIRECT, STAGED, AttentionConfig, MemoryConfig,
                    ResolvedPlan, WritePath, build_decision, negotiate,
                    resolve_attention, resolve_device, validate)
from .policy import AlwaysOffload, AlwaysUnload, FrequencyPolicy
from .ring import RingState
from .types import (PHASE_BULK, PHASE_SCATTERED, DecisionStats, WriteBatch,
                    make_write_batch)

__all__ = [
    "decision", "monitor", "paths", "policy", "ring", "types",
    "DecisionModule", "ExactMonitor", "MonitorState", "ADAPTIVE", "DIRECT",
    "STAGED", "AttentionConfig", "MemoryConfig", "ResolvedPlan", "WritePath",
    "build_decision", "negotiate", "resolve_attention", "resolve_device",
    "validate", "AlwaysOffload", "AlwaysUnload", "FrequencyPolicy",
    "RingState", "PHASE_BULK", "PHASE_SCATTERED", "DecisionStats",
    "WriteBatch", "make_write_batch",
]
