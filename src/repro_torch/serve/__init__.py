"""Cost-aware serving (counterpart of `repro/serve`): the paper's
adaptive-termination signal (predicted budget Ŵ_q) used as a scheduling
signal — admission control, fixed-shape micro-batching, budget-bucketed
batch formation, and resume-based preemption over the lockstep engine on
the card."""
from repro_torch.serve.queue import (AdmissionQueue, Request,
                                     requests_from_workload, take_requests)
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.cache import ResultCache, request_key
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.scheduler import CostAwareScheduler, ServeConfig

__all__ = [
    "AdmissionQueue",
    "Request",
    "requests_from_workload",
    "take_requests",
    "MicroBatcher",
    "ResultCache",
    "request_key",
    "ServeMetrics",
    "CostAwareScheduler",
    "ServeConfig",
]
