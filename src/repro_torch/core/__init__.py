"""Port of repro/core/__init__.py: the paper's contribution as composable
PyTorch modules.

  types         WriteBatch, phase tags, DecisionStats, SpecStats,
                resolve_device
  monitor       heavy-hitter counters: exact array + count-min sketch
  policy        AlwaysOffload / AlwaysUnload / Hint / Frequency / Hysteresis
  decision      DecisionModule: per-request offload/unload routing
  umtt          software registration map (security parity)
  ring          staging-ring bookkeeping, drain eligibility, drain copies
  unload        the flat staging ring + validated drain
  staged_write  RemoteWriteEngine: the bidirectional write API
  paths         WritePath registry, capability negotiation, validate()
  simulator     the paper's Fig. 3 simulator: zipf_regions, RDMASimulator
                (MTT + dTLB LRU scan on the lru_scan kernel), sweep_point

``validate`` is the uMTT's security check, as in the JAX package; the
config -> plan entry point is ``paths.validate``.
"""
from . import (decision, monitor, paths, policy, ring, simulator,
               staged_write, types, umtt, unload)
from .decision import DecisionModule, page_threshold
from .monitor import (CMSMonitor, ExactMonitor, MonitorState,
                      calibrate_threshold)
from .paths import (ADAPTIVE, DIRECT, STAGED, AttentionConfig, MemoryConfig,
                    ResolvedPlan, SpecConfig, WritePath, available_paths,
                    build_decision, get_path, negotiate, register_path,
                    resolve_attention, resolve_draft)
from .policy import (AlwaysOffload, AlwaysUnload, FrequencyPolicy, HintPolicy,
                     HysteresisPolicy, available_policies, get_policy_factory,
                     register_policy, top_k_hot_table)
from .ring import RingState
from .simulator import RDMASimulator, SimResult, sweep_point, zipf_regions
from .staged_write import EngineState, RemoteWriteEngine
from .types import (OFFLOAD, PHASE_BULK, PHASE_SCATTERED, UNLOAD,
                    CPUTLBConfig, DecisionStats, LatencyModel, MTTConfig,
                    SpecStats, WriteBatch, make_write_batch, resolve_device)
from .umtt import (PERM_READ, PERM_WRITE, UMTT, deregister, make_umtt,
                   register, validate)
from .unload import StagingRing, append, drain, make_ring, need_drain

__all__ = [
    "decision", "monitor", "paths", "policy", "ring", "simulator",
    "staged_write", "types", "umtt", "unload",
    "DecisionModule", "page_threshold", "CMSMonitor", "ExactMonitor",
    "MonitorState", "calibrate_threshold", "ADAPTIVE", "DIRECT", "STAGED",
    "AttentionConfig", "MemoryConfig", "ResolvedPlan", "SpecConfig",
    "resolve_draft", "WritePath",
    "available_paths", "build_decision", "get_path", "negotiate",
    "register_path", "resolve_attention", "AlwaysOffload", "AlwaysUnload",
    "FrequencyPolicy", "HintPolicy", "HysteresisPolicy", "available_policies",
    "get_policy_factory", "register_policy", "top_k_hot_table", "RingState",
    "zipf_regions", "RDMASimulator", "SimResult", "sweep_point",
    "MTTConfig", "CPUTLBConfig", "EngineState", "RemoteWriteEngine", "OFFLOAD",
    "PHASE_BULK", "PHASE_SCATTERED", "UNLOAD", "DecisionStats",
    "LatencyModel", "SpecStats", "WriteBatch",
    "make_write_batch", "resolve_device", "PERM_READ", "PERM_WRITE", "UMTT",
    "deregister", "make_umtt", "register", "validate", "StagingRing",
    "append", "drain", "make_ring", "need_drain",
]
