"""Port of repro/serve/traffic/sched.py (the serving path's share).

Admission policies + their registry. An :class:`AdmissionPolicy` owns the
ORDER in which the scheduler's admission pass scans the waiting queue and
nothing else. Only ``"fifo"`` is ported; ``sched/priority``,
``sched/deadline`` and ``sched/preempt`` raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

__all__ = [
    "AdmissionPolicy", "FifoAdmission", "register_sched",
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


_SCHEDS: Dict[str, Callable[[], AdmissionPolicy]] = {}
_NOT_PORTED = ("sched/priority", "sched/deadline", "sched/preempt")


def register_sched(name: str, factory: Callable[[], AdmissionPolicy], *,
                   overwrite: bool = False) -> None:
    if name in _SCHEDS and not overwrite:
        raise ValueError(
            f"sched {name!r} already registered "
            f"(pass overwrite=True to replace it)")
    _SCHEDS[name] = factory


def get_sched_factory(name: str) -> Callable[[], AdmissionPolicy]:
    if name in _SCHEDS:
        return _SCHEDS[name]
    if name in _NOT_PORTED:
        raise NotImplementedError(f"not ported yet: sched {name!r}")
    raise ValueError(
        f"unknown sched {name!r}; registered scheds: {sorted(_SCHEDS)}")


def available_scheds() -> Tuple[str, ...]:
    return tuple(sorted(_SCHEDS))


def build_sched(name: str) -> AdmissionPolicy:
    """Instantiate the named admission policy."""
    return get_sched_factory(name)()


register_sched("fifo", FifoAdmission)
