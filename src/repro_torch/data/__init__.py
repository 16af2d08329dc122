"""Port of repro/data/__init__.py: the request queue and workload."""
from ..models.sampling import SamplingParams
from .pipeline import Request, RequestQueue, synthetic_requests

__all__ = ["Request", "RequestQueue", "SamplingParams", "synthetic_requests"]
