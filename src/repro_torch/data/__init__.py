"""Port of repro/data/__init__.py: the training token pipeline, the request
queue and workload."""
from ..models.sampling import SamplingParams
from .pipeline import (DataConfig, MemmapSource, Pipeline, Request,
                       RequestQueue, SyntheticSource, synthetic_requests)

__all__ = ["DataConfig", "MemmapSource", "Pipeline", "Request",
           "RequestQueue", "SamplingParams", "SyntheticSource",
           "synthetic_requests"]
