"""Port of repro/core/types.py (the serving path's share).

Core datatypes of the bidirectional-offload engine: ``WriteBatch``
(structure-of-arrays batch of write requests), the write-phase tags and
``DecisionStats``. Everything is a NamedTuple of tensors on one explicit
device. ``LatencyModel`` holds the paper's per-path write latencies, the
constants of the virtual-time cost model (``serve.traffic``); ``SpecStats``
the speculative path's tallies. ``MTTConfig`` and ``CPUTLBConfig`` belong to
the simulator and are not ported yet.

Conventions: region ids and the other integer fields are int64 tensors
(PyTorch's index type); the JAX package uses int32 for the same values.
``resolve_device`` lives here (and is re-exported by ``paths``) so that every
core module can default its state to the card without an import cycle.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

# Path labels (values of a decision mask).
OFFLOAD = 0  # keep on the offloaded (RNIC / direct-scatter) path
UNLOAD = 1   # reroute to the unload (staging buffer + local copy) path

# Write-phase tags (values of ``WriteBatch.phase``).
PHASE_SCATTERED = 0  # single-row decode-time write (routing is adaptive)
PHASE_BULK = 1       # contiguous prefill-chunk write (always offload)


class WriteBatch(NamedTuple):
    """A batch of RDMA-write-like requests (structure of arrays).

    region:  int[n]  destination region / page / expert id
    offset:  int[n]  byte offset within the region (framework: slot id)
    size:    int[n]  payload bytes (paper evaluates 16 B inlined writes)
    hint:    int[n]  application hint: 1 = "offload me"; 0 = no hint
    phase:   int[n]  PHASE_SCATTERED or PHASE_BULK; None means scattered
    """

    region: torch.Tensor
    offset: torch.Tensor
    size: torch.Tensor
    hint: torch.Tensor
    phase: Optional[torch.Tensor] = None

    @property
    def n(self) -> int:
        return self.region.shape[0]


def resolve_device(device="cuda") -> torch.device:
    """The device state is made on. Asking for CUDA on a machine without it
    RAISES: nothing carries on on the CPU by itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was asked for but "
            f"torch.cuda.is_available() is False; pass device='cpu' to run "
            f"on the CPU on purpose")
    return dev


def _ints(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int64)


def make_write_batch(region, offset=None, size=None, hint=None, phase=None,
                     device=None) -> WriteBatch:
    """``device`` defaults to ``region``'s own when it is a tensor."""
    if device is None:
        device = region.device if isinstance(region, torch.Tensor) else "cpu"
    region = _ints(region, device)
    n = region.shape[0]
    if offset is None:
        offset = torch.zeros((n,), dtype=torch.int64, device=device)
    if size is None:  # paper: 16 B inlined writes
        size = torch.full((n,), 16, dtype=torch.int64, device=device)
    if hint is None:
        hint = torch.zeros((n,), dtype=torch.int64, device=device)
    if phase is None:
        phase = torch.full((n,), PHASE_SCATTERED, dtype=torch.int64,
                           device=device)
    return WriteBatch(region, _ints(offset, device), _ints(size, device),
                      _ints(hint, device), _ints(phase, device))


class DecisionStats(NamedTuple):
    """Aggregated routing statistics. ``n_bulk`` splits the offloaded tally
    by phase: bulk writes are pinned to the offload path, so ``n_offloaded -
    n_bulk`` is the scattered traffic the policy chose to keep direct."""

    n_offloaded: torch.Tensor
    n_unloaded: torch.Tensor
    n_bulk: torch.Tensor

    @staticmethod
    def from_mask(unload_mask: torch.Tensor, valid=None,
                  phase=None) -> "DecisionStats":
        """``valid`` (bool[n], optional) restricts the tally to live
        requests; ``phase`` tallies live PHASE_BULK writes separately."""
        u = unload_mask.sum()
        nb = torch.zeros((), dtype=torch.int64, device=unload_mask.device)
        if phase is not None:
            bulk = phase == PHASE_BULK
            if valid is not None:
                bulk = bulk & valid
            nb = bulk.sum()
        if valid is None:
            return DecisionStats(unload_mask.shape[0] - u, u, nb)
        return DecisionStats(valid.sum() - u, u, nb)


class SpecStats(NamedTuple):
    """Per-segment speculative-decoding tallies, the third path's analogue
    of :class:`DecisionStats`. ``n_committed`` counts the tokens emitted
    (the accepted run plus the target's own token each round, cut at a stop
    or the budget), so ``n_committed / n_rounds`` is the committed tokens
    per target verify step. int64 scalars, summed across segments on the
    host."""

    n_proposed: torch.Tensor   # draft tokens offered to the verifier
    n_accepted: torch.Tensor   # draft tokens the target accepted
    n_committed: torch.Tensor  # tokens emitted (accepted + target samples)
    n_rounds: torch.Tensor     # verify rounds = target forward passes

    @staticmethod
    def zero(device="cpu") -> "SpecStats":
        return SpecStats(*(torch.zeros((), dtype=torch.int64, device=device)
                           for _ in range(4)))


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    """The paper's cost model of the two write paths, in microseconds. These
    are model constants taken from the paper's text, not measurements of
    any device.

    Offload path (one-sided RDMA write, target-side view):
      * MTT hit:  ``t_offload_hit`` (paper: ~2.6 us RTT with 1 region)
      * MTT miss: ``t_offload_miss`` (translation fetched over PCIe; set so
        the Zipf(0.5), 2^20-region mix averages ~5.1 us as in Fig. 3)
    Unload path (RDMA writeImm into the staging ring + CPU copy):
      * base: ``t_unload_base`` (paper: ~3.4 us flat)
      * CPU dTLB walk on a cold destination page: ``t_cpu_tlb_walk``
      * copy: size / ``copy_gbps`` for payloads beyond the inlined 16 B.
    """

    t_offload_hit: float = 2.60
    t_offload_miss: float = 5.13
    t_unload_base: float = 3.38
    t_cpu_tlb_walk: float = 0.12
    copy_gbps: float = 12.0  # memcpy GB/s for the staged->final copy

    def unload_copy_us(self, size_bytes: torch.Tensor) -> torch.Tensor:
        extra = torch.clamp(size_bytes.to(torch.float32) - 16.0, min=0.0)
        return extra / (self.copy_gbps * 1e3)  # bytes / (GB/s) -> us
