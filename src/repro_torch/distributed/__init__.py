"""Distributed runtime: the EP groups (``torch.distributed`` across
processes, or in-process virtual ranks), the dispatch collectives (the
monolithic all-to-all and Aurora's permutation rounds), and the mesh
transports of the rank program (``mesh``: threads, ``torch.distributed``,
counting on ``meta``)."""

from .alltoall import (aurora_rounds_from_schedule, ep_all_to_all,
                       ep_dispatch_combine, round_robin_rounds)
from .group import DistGroup, EPGroup, LocalGroup
from .mesh import CountingMesh, DistMesh, RankMesh, ThreadMesh
from .overlap import pipelined_dispatch_combine

__all__ = ["CountingMesh", "DistGroup", "DistMesh", "EPGroup", "LocalGroup",
           "RankMesh", "ThreadMesh", "aurora_rounds_from_schedule",
           "ep_all_to_all", "ep_dispatch_combine",
           "pipelined_dispatch_combine", "round_robin_rounds"]
