"""Port of repro/serve/traffic/__init__.py: only the admission-order
registry (``sched``) is ported; the workload generator and the loadtest
harness are not ported yet."""
from .sched import (AdmissionPolicy, FifoAdmission, available_scheds,
                    build_sched, get_sched_factory, register_sched)

__all__ = ["AdmissionPolicy", "FifoAdmission", "available_scheds",
           "build_sched", "get_sched_factory", "register_sched"]
