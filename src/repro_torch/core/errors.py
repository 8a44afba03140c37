"""Typed exceptions for planning and fault handling.

Two families:

``PlanError``
    A plan, pairing, schedule, or adoption request is malformed or cannot
    be applied to the engine's live state (bad permutation, wrong tenant
    count, EP-indivisible replication, ...). Subclasses ``ValueError`` so
    pre-existing ``except ValueError`` call sites — and tests asserting
    ``pytest.raises(ValueError)`` — keep working.

``FaultError``
    A fault-handling operation cannot proceed: an injected fault targets a
    device/expert that does not exist, failover would lose the last copy of
    an expert's weights, or a degraded re-plan is impossible on the
    surviving devices. Subclasses ``RuntimeError`` — these are runtime
    conditions, not argument validation.
"""

from __future__ import annotations

__all__ = ["PlanError", "FaultError"]


class PlanError(ValueError):
    """A plan/pairing/schedule is invalid or cannot be adopted as-is."""


class FaultError(RuntimeError):
    """A fault-injection or failover operation cannot proceed."""
