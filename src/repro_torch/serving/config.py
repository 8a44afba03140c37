"""Engine configuration (port of the subset of ``repro/serving/config.py``
that one-shot admission uses).

``EngineConfig`` carries ``prefill_len``, ``bucket_policy`` and ``kernels``;
its admission policy is ``FifoAdmission`` (one-shot admission in arrival
order). Chunked admission, token budgets, deadline policies and tenants are
not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence


def make_bucketer(policy) -> Callable[[int], int]:
    """Resolve a prefill bucketing policy to ``fn(prompt_len) -> pad_len``.

      "pow2"     next power of two (default)
      "exact"    no padding
      "step:K"   round up to a multiple of K
      callable   custom ``fn(n) -> >= n``
    """
    if callable(policy):
        return policy
    if policy == "pow2":
        def pow2(n: int) -> int:
            p = 1
            while p < n:
                p *= 2
            return p
        return pow2
    if policy == "exact":
        return lambda n: n
    if isinstance(policy, str) and policy.startswith("step:"):
        k = int(policy.split(":", 1)[1])
        if k <= 0:
            raise ValueError(f"bucket_policy 'step:K' needs a positive K, "
                             f"got {k}")
        return lambda n: -(-n // k) * k
    raise ValueError(f"bucket_policy {policy!r} is unknown "
                     "(expected 'pow2', 'exact', 'step:K', or a callable)")


@dataclasses.dataclass(frozen=True)
class RequestSpec:
    """What an admission policy sees about one pending request: its next
    prefill chunk in tokens, prompt length, arrival and absolute deadline
    (engine-step time; ``math.inf`` = none) and an opaque tenant id."""

    chunk: int
    prompt_len: int = 0
    arrival: float = 0.0
    deadline: float = math.inf
    tenant: object = None

    def __post_init__(self):
        if self.chunk < 0:
            raise ValueError("RequestSpec.chunk must be a non-negative "
                             "token count")
        if math.isnan(self.deadline):
            raise ValueError("RequestSpec.deadline must be a time or "
                             "math.inf, not NaN")


def _fifo_order(reqs: Sequence[RequestSpec]) -> tuple[int, ...]:
    return tuple(range(len(reqs)))


@dataclasses.dataclass(frozen=True)
class FifoAdmission:
    """One-shot admission in arrival order (no chunking): each free slot
    absorbs a whole bucketed prompt in one prefill."""

    bucket_policy: object = "pow2"
    chunk = None
    budget = None

    def pad(self, prompt_len: int) -> int:
        return make_bucketer(self.bucket_policy)(prompt_len)

    def select(self, num_active: int,
               reqs: Sequence[RequestSpec]) -> tuple[int, ...]:
        return _fifo_order(reqs)

    def order(self, reqs: Sequence[RequestSpec]) -> tuple[int, ...]:
        return _fifo_order(reqs)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Scheduling knobs of the continuous engine.

    ``prefill_len``: fixed left-pad length of every prompt (None = bucket by
    ``bucket_policy``). ``kernels``: ``False`` (plain dense path), ``True``
    (default ``KernelConfig``) or an explicit ``KernelConfig``, applied by
    ``kernelize`` through ``Model.with_kernels``.
    """

    prefill_len: int | None = None
    bucket_policy: object = "pow2"
    kernels: object = False          # bool | KernelConfig

    def __post_init__(self):
        if self.prefill_len is not None and self.prefill_len <= 0:
            raise ValueError("prefill_len must be a positive token count")
        make_bucketer(self.bucket_policy)      # raises on an unknown policy

    def resolve_admission(self) -> FifoAdmission:
        return FifoAdmission(bucket_policy=self.bucket_policy)

    def kernelize(self, model):
        """Route ``model`` through the kernel hot path per ``self.kernels``
        (no-op when False)."""
        return model.with_kernels(self.kernels)
