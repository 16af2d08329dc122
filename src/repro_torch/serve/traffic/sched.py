"""Port of repro/serve/traffic/sched.py.

Admission policies + their registry. An :class:`AdmissionPolicy` owns the
ORDER in which the scheduler's admission pass scans the waiting queue and
nothing else: a pure host-side permutation of queue indices, recomputed on
every admission pass. The scan itself (first fit with bounded skip-ahead,
block budgets, prefix lookups) is the scheduler's, and skip-ahead counts
the policy's head. Every policy sorts with the queue index as the last key
(Python's sort is stable), so equal requests admit strictly FIFO.

``sched/preempt`` also sets ``preempts``, which arms the scheduler's
preempt-and-requeue path through the host tier; ``core.paths.validate``
refuses it without ``memory.host_tier``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

__all__ = [
    "AdmissionPolicy", "FifoAdmission", "PriorityAdmission",
    "DeadlineAdmission", "PreemptAdmission", "register_sched",
    "get_sched_factory", "available_scheds", "build_sched",
]


class AdmissionPolicy:
    """Admission-order contract: ``order(queue)`` returns a permutation of
    ``range(len(queue))``, the index order the scheduler's admission pass
    scans the waiting queue in."""

    name: str = "?"
    preempts: bool = False

    def order(self, queue) -> List[int]:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}(name={self.name!r})"


class FifoAdmission(AdmissionPolicy):
    """Arrival order: the identity permutation (the default)."""

    name = "fifo"

    def order(self, queue) -> List[int]:
        return list(range(len(queue)))


class PriorityAdmission(AdmissionPolicy):
    """Highest ``Request.priority`` first; FIFO among equal priorities."""

    name = "sched/priority"

    def order(self, queue) -> List[int]:
        n = len(queue)
        return sorted(range(n), key=lambda i: (-queue.at(i).priority, i))


class DeadlineAdmission(AdmissionPolicy):
    """Earliest deadline first over ``Request.deadline_s`` (arrival + TTFT
    SLO for generated workloads); FIFO among equal deadlines. The earliest
    deadline that does not fit is passed over at most ``skip_ahead_limit``
    rounds before admission stalls for it."""

    name = "sched/deadline"

    def order(self, queue) -> List[int]:
        n = len(queue)
        return sorted(range(n), key=lambda i: (queue.at(i).deadline_s, i))


class PreemptAdmission(PriorityAdmission):
    """Priority admission + preemption: a waiting request of STRICTLY
    higher priority than the lowest-priority running slot evicts it through
    the host tier (strictness prevents equal-priority ping-pong)."""

    name = "sched/preempt"
    preempts = True


_SCHEDS: Dict[str, Callable[[], AdmissionPolicy]] = {}


def register_sched(name: str, factory: Callable[[], AdmissionPolicy], *,
                   overwrite: bool = False) -> None:
    """Register an :class:`AdmissionPolicy` factory under ``name``."""
    if name in _SCHEDS and not overwrite:
        raise ValueError(
            f"sched {name!r} already registered "
            f"(pass overwrite=True to replace it)")
    _SCHEDS[name] = factory


def get_sched_factory(name: str) -> Callable[[], AdmissionPolicy]:
    try:
        return _SCHEDS[name]
    except KeyError:
        raise ValueError(
            f"unknown sched {name!r}; registered scheds: "
            f"{sorted(_SCHEDS)}") from None


def available_scheds() -> Tuple[str, ...]:
    return tuple(sorted(_SCHEDS))


def build_sched(name: str) -> AdmissionPolicy:
    """Instantiate the named admission policy."""
    return get_sched_factory(name)()


register_sched("fifo", FifoAdmission)
register_sched("sched/priority", PriorityAdmission)
register_sched("sched/deadline", DeadlineAdmission)
register_sched("sched/preempt", PreemptAdmission)
