"""Serving engine, its configuration and admission policies."""

from .config import (AdmissionPolicy, EdfAdmission, EngineConfig,
                     FifoAdmission, LengthBucketedAdmission, RequestSpec,
                     ShedEvent, TenantSpec, TokenBudgetAdmission,
                     make_bucketer, scale_admission)
from .engine import ContinuousEngine, Request, poisson_requests, serve_stream
from .events import RingBuffer

__all__ = ["AdmissionPolicy", "ContinuousEngine", "EdfAdmission",
           "EngineConfig", "FifoAdmission", "LengthBucketedAdmission",
           "Request", "RequestSpec", "RingBuffer", "ShedEvent", "TenantSpec",
           "TokenBudgetAdmission", "make_bucketer", "poisson_requests",
           "scale_admission", "serve_stream"]
