"""Aurora core: MoE inference deployment + communication scheduling.

The port's own copy of the JAX package's ``core`` (pure numpy, relative
imports only), kept bit-equal to it: the same traces give the same
pairings, groups, assignments, schedules and simulated times.

The paper's contribution as a composable library:

- ``traffic``     — traffic matrices, b_max bounds, trace generation
- ``schedule``    — Thm 4.2/5.2 BvN contention-free schedules + baselines
- ``matching``    — Hopcroft–Karp, bottleneck perfect matching
- ``assignment``  — Thm 5.1 heterogeneous GPU assignment
- ``colocation``  — Thm 6.2 cross-model expert colocation
- ``simulator``   — Table 2 / Eqn 1–4 inference-time model
- ``planner``     — the 4-scenario AuroraPlanner
- ``bruteforce``  — exhaustive optima for validation
"""

from .cluster import (Cluster, DeviceType, heterogeneous_cluster,
                      homogeneous_cluster, PAPER_HET_TIERS)
from .errors import FaultError, PlanError
from .traffic import (MoETrace, add_noise, b_max_heterogeneous,
                      b_max_homogeneous, degraded_ffn_loads, degraded_traffic,
                      identity_replication, paper_eval_traces,
                      replicated_ffn_loads, replicated_traffic,
                      synthetic_trace, trace_from_counts,
                      traffic_from_routing, validate_degraded_hosts,
                      validate_replication)
from .schedule import (CommSchedule, Slot, aurora_schedule, comm_time,
                       fluid_comm_time, rcs_order, sjf_order)
from .matching import bottleneck_perfect_matching, hopcroft_karp
from .assignment import (apply_assignment, aurora_assignment, expert_loads,
                         random_assignment)
from .colocation import (aggregate_traffic, aggregate_traffic_multi,
                         aurora_grouping, aurora_pairing, case1_pairing,
                         case2_pairing, group_pairs, lina_packing,
                         random_grouping, random_pairing)
from .simulator import (SimResult, colocated_inference_time,
                        degraded_inference_time, exclusive_inference_time,
                        lina_inference_time, multi_colocated_inference_time,
                        replicated_inference_time)
from .planner import AuroraPlanner, Plan, PlanDiff, diff_plans
from .bruteforce import bruteforce_colocated, bruteforce_exclusive

__all__ = [
    "Cluster", "DeviceType", "heterogeneous_cluster", "homogeneous_cluster",
    "PAPER_HET_TIERS", "MoETrace", "add_noise", "b_max_heterogeneous",
    "b_max_homogeneous", "paper_eval_traces", "synthetic_trace",
    "trace_from_counts", "traffic_from_routing", "CommSchedule", "Slot",
    "aurora_schedule",
    "comm_time", "fluid_comm_time", "rcs_order", "sjf_order",
    "bottleneck_perfect_matching", "hopcroft_karp", "apply_assignment",
    "aurora_assignment", "expert_loads", "random_assignment",
    "aggregate_traffic", "aggregate_traffic_multi", "aurora_grouping",
    "aurora_pairing", "case1_pairing", "case2_pairing", "group_pairs",
    "lina_packing", "random_grouping", "random_pairing", "SimResult",
    "colocated_inference_time", "exclusive_inference_time",
    "lina_inference_time", "multi_colocated_inference_time",
    "replicated_inference_time", "identity_replication",
    "replicated_ffn_loads", "replicated_traffic", "validate_replication",
    "degraded_inference_time", "degraded_ffn_loads", "degraded_traffic",
    "validate_degraded_hosts", "FaultError", "PlanError",
    "AuroraPlanner", "Plan", "PlanDiff", "diff_plans",
    "bruteforce_colocated", "bruteforce_exclusive",
]
