"""Expert-parallel runtime: the EP groups (``torch.distributed`` across
processes, or in-process virtual ranks) and the dispatch collectives, the
monolithic all-to-all and Aurora's permutation rounds."""

from .alltoall import (aurora_rounds_from_schedule, ep_all_to_all,
                       ep_dispatch_combine, round_robin_rounds)
from .group import DistGroup, EPGroup, LocalGroup
from .overlap import pipelined_dispatch_combine

__all__ = ["DistGroup", "EPGroup", "LocalGroup",
           "aurora_rounds_from_schedule", "ep_all_to_all",
           "ep_dispatch_combine", "pipelined_dispatch_combine",
           "round_robin_rounds"]
