"""Port of repro/serve/traffic: the open-loop traffic stack.

* :mod:`~repro_torch.serve.traffic.workload`: arrival processes (Poisson,
  Markov-modulated, trace replay), tenant request classes with SLOs, the
  :class:`VirtualClock` and the :class:`SegmentCostModel`.
* :mod:`~repro_torch.serve.traffic.sched`: admission policies (``fifo``,
  ``sched/priority``, ``sched/deadline``, ``sched/preempt``) and their
  registry, negotiated through ``core.paths.validate``.
* :mod:`~repro_torch.serve.traffic.harness`: the open-loop loadtest runner,
  goodput under SLO and TTFT / ITL percentiles per tenant class.
"""
from .harness import ClassReport, LoadtestResult, run_loadtest
from .sched import (AdmissionPolicy, DeadlineAdmission, FifoAdmission,
                    PreemptAdmission, PriorityAdmission, available_scheds,
                    build_sched, get_sched_factory, register_sched)
from .workload import (ArrivalProcess, MarkovModulatedArrivals,
                       PoissonArrivals, RequestClass, SegmentCostModel,
                       TimedRequest, TraceArrivals, VirtualClock,
                       generate_workload, load_trace, make_queue,
                       save_trace)

__all__ = [
    "AdmissionPolicy", "ArrivalProcess", "ClassReport", "DeadlineAdmission",
    "FifoAdmission", "LoadtestResult", "MarkovModulatedArrivals",
    "PoissonArrivals", "PreemptAdmission", "PriorityAdmission",
    "RequestClass", "SegmentCostModel", "TimedRequest", "TraceArrivals",
    "VirtualClock", "available_scheds", "build_sched", "generate_workload",
    "get_sched_factory", "load_trace", "make_queue", "register_sched",
    "run_loadtest", "save_trace",
]
