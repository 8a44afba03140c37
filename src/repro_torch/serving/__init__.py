"""Serving engine and its configuration."""

from .config import EngineConfig, FifoAdmission, RequestSpec, make_bucketer
from .engine import ContinuousEngine, Request, poisson_requests, serve_stream

__all__ = ["ContinuousEngine", "EngineConfig", "FifoAdmission", "Request",
           "RequestSpec", "make_bucketer", "poisson_requests", "serve_stream"]
