"""Serving: the continuous engine, its configuration and admission
policies, the colocated and multi-tenant engines, and live traffic
monitoring with online re-planning and re-grouping."""

from ..core.errors import PlanError
from .config import (AdmissionPolicy, EdfAdmission, EngineConfig,
                     FifoAdmission, LengthBucketedAdmission, RequestSpec,
                     ShedEvent, TenantSpec, TokenBudgetAdmission,
                     make_bucketer, scale_admission)
from .engine import ContinuousEngine, Request, poisson_requests, serve_stream
from .colocated import (ColocatedContinuousEngine, ColocatedEngine,
                        MultiTenantContinuousEngine, apply_pairing,
                        build_lockstep_step, inverse_pair, reseat_pairing)
from .monitor import OnlineReplanner, ReplanEvent, TrafficMonitor
from .events import RingBuffer

__all__ = ["AdmissionPolicy", "ColocatedContinuousEngine", "ColocatedEngine",
           "ContinuousEngine", "EdfAdmission", "EngineConfig",
           "FifoAdmission", "LengthBucketedAdmission",
           "MultiTenantContinuousEngine", "OnlineReplanner", "PlanError",
           "ReplanEvent", "Request", "RequestSpec", "RingBuffer", "ShedEvent",
           "TenantSpec", "TokenBudgetAdmission", "TrafficMonitor",
           "apply_pairing", "build_lockstep_step", "inverse_pair",
           "make_bucketer", "poisson_requests", "reseat_pairing",
           "scale_admission", "serve_stream"]
