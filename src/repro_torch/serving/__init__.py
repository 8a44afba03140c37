"""Serving: the static and continuous engines, their configuration and
admission policies, the colocated and multi-tenant engines, live traffic
monitoring with online re-planning, re-grouping and re-replication, fault
tolerance (seedable fault injection, health monitoring, recovery) and the
telemetry hub (metrics registry, structured spans, bounded event bus:
``EngineConfig(telemetry=Telemetry())``), and the ``Distributed*``
engines, whose MoE layers run expert-parallel over an EP group with
Aurora's permutation rounds."""

from ..core.errors import FaultError, PlanError
from .config import (AdmissionPolicy, EdfAdmission, EngineConfig,
                     FifoAdmission, LengthBucketedAdmission, RequestSpec,
                     ShedEvent, TenantSpec, TokenBudgetAdmission,
                     coerce_admission, make_bucketer, scale_admission)
from .engine import (ContinuousEngine, Request, ServingEngine,
                     poisson_requests, serve_stream)
from .colocated import (ColocatedContinuousEngine, ColocatedEngine,
                        MultiTenantContinuousEngine, apply_pairing,
                        build_lockstep_step, inverse_pair, reseat_pairing)
from .monitor import OnlineReplanner, ReplanEvent, TrafficMonitor
from .health import FaultEvent, HealthMonitor
from .faults import (ChaosHarness, DeviceLoss, ExpertCorruption,
                     FaultInjector, FaultPlan, Straggler)
from .events import BusEvent, EventBus, RingBuffer
from .distributed import (DistributedColocatedEngine, DistributedEngine,
                          DistributedMultiTenantEngine, device_traffic,
                          distribute, ep_size, resolve_rounds,
                          rounds_from_plan, rounds_from_trace,
                          rounds_from_traffic)
from .telemetry import (MetricsRegistry, SpanRecord, Telemetry,
                        record_adoption)

__all__ = ["AdmissionPolicy", "BusEvent", "ChaosHarness",
           "ColocatedContinuousEngine", "ColocatedEngine",
           "ContinuousEngine", "DeviceLoss", "DistributedColocatedEngine",
           "DistributedEngine", "DistributedMultiTenantEngine",
           "EdfAdmission", "EngineConfig",
           "EventBus", "ExpertCorruption", "FaultError", "FaultEvent",
           "FaultInjector", "FaultPlan", "FifoAdmission", "HealthMonitor",
           "LengthBucketedAdmission", "MetricsRegistry",
           "MultiTenantContinuousEngine", "OnlineReplanner", "PlanError",
           "ReplanEvent", "Request", "RequestSpec", "RingBuffer",
           "ServingEngine", "ShedEvent",
           "SpanRecord", "Straggler", "Telemetry", "TenantSpec",
           "TokenBudgetAdmission", "TrafficMonitor", "apply_pairing",
           "build_lockstep_step", "coerce_admission", "device_traffic",
           "distribute",
           "ep_size", "inverse_pair", "make_bucketer", "poisson_requests",
           "record_adoption", "reseat_pairing", "resolve_rounds",
           "rounds_from_plan", "rounds_from_trace", "rounds_from_traffic",
           "scale_admission", "serve_stream"]
