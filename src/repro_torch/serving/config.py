"""Engine configuration and admission policies (port of
``repro/serving/config.py``).

``EngineConfig`` carries the scheduling knobs of the continuous engine. An
``AdmissionPolicy`` decides how queued prompts enter the slot pool:

* ``FifoAdmission``: one-shot admission in arrival order; a free slot
  absorbs the whole bucketed prompt in one prefill.
* ``LengthBucketedAdmission``: chunked admission; prompts are bucketed to
  a pad length and absorbed ``chunk`` tokens per engine step.
* ``TokenBudgetAdmission``: chunked admission under a per-step token
  budget; decode eats ``num_active`` tokens of it, prefill chunks run on
  the leftover, FIFO prefix.
* ``EdfAdmission``: earliest effective deadline first within the budget,
  starvation-free through aging, and with ``shed=True`` typed
  ``ShedEvent`` rejections of provably late or over-cap submits.

Policies see pending requests as ``RequestSpec`` objects through
``select(num_active, reqs)`` (which due chunks run this step, in run order)
and ``order(reqs)`` (the queue discipline). Reordering is placement-only:
each request's tokens depend only on its own slot row.

``TenantSpec`` declares a tenant's SLO targets (engine-step units), which
the engine turns into per-request deadlines at submit, and for the
multi-tenant engine its model, params and expert pairing.

The reference's deprecated surfaces are kept as its shims keep them:
the engines take its old constructor keywords (``_LEGACY_KEYS``), folded
into an ``EngineConfig`` by ``coerce_config`` with one
``DeprecationWarning`` per engine; a policy that implements only the old
int-based ``chunk_budget(num_active, chunks)`` is wrapped into ``select``
(``coerce_admission``, one warning per config); and the stock policies
still answer ``chunk_budget`` (with a warning) through ``select``.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, Protocol, Sequence


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


@dataclasses.dataclass(frozen=True)
class ShedEvent:
    """One rejected submit under shed-mode admission: ``submit`` returns it
    and appends it to ``engine.shed_events``. ``reason`` starts with the
    trigger (``"queue_cap"`` or ``"deadline"``)."""

    tenant: object
    arrival: float
    reason: str
    request: object = None


def _fifo_order(reqs: Sequence[RequestSpec]) -> tuple[int, ...]:
    return tuple(range(len(reqs)))


def _deprecated_chunk_budget(policy, num_active: int,
                             chunks: Sequence[int]) -> int:
    warnings.warn(
        f"{type(policy).__name__}.chunk_budget(num_active, chunks) is "
        "deprecated — admission policies now expose select(num_active, "
        "reqs) over RequestSpec objects (repro_torch.serving.RequestSpec)",
        DeprecationWarning, stacklevel=3)
    return len(policy.select(num_active,
                             [RequestSpec(chunk=int(c)) for c in chunks]))


class AdmissionPolicy(Protocol):
    """How queued prompts enter the slot pool.

    ``chunk`` is the per-step prefill granularity (None = one-shot whole
    prompts), ``budget`` the per-step token budget (None = unbudgeted);
    ``pad`` buckets a prompt length to its pad length. ``select`` picks,
    given the decode load and the pending prefills' specs (arrival order),
    which due chunks run this step, as indices in run order; ``order`` is
    the priority in which queued requests enter the prefill pool.
    """

    chunk: int | None
    budget: int | None

    def pad(self, prompt_len: int) -> int: ...

    def select(self, num_active: int,
               reqs: Sequence[RequestSpec]) -> tuple[int, ...]: ...

    def order(self, reqs: Sequence[RequestSpec]) -> tuple[int, ...]: ...


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

    def chunk_budget(self, num_active: int, chunks: Sequence[int]) -> int:
        """Deprecated: the number of ``chunks`` that ``select`` runs."""
        return _deprecated_chunk_budget(self, num_active, chunks)


@dataclasses.dataclass(frozen=True)
class LengthBucketedAdmission:
    """Chunked admission: prompts bucketed to a pad length and absorbed
    ``chunk`` tokens per engine step, unbudgeted (every in-flight prefill
    may advance one chunk per step)."""

    chunk: int
    bucket_policy: object = "pow2"
    budget = None

    def __post_init__(self):
        if self.chunk <= 0:
            raise ValueError("LengthBucketedAdmission.chunk must be a "
                             "positive token count")

    def pad(self, prompt_len: int) -> int:
        return make_bucketer(self.bucket_policy)(prompt_len)

    def select(self, num_active: int,
               reqs: Sequence[RequestSpec]) -> tuple[int, ...]:
        return _fifo_order(reqs)

    def order(self, reqs: Sequence[RequestSpec]) -> tuple[int, ...]:
        return _fifo_order(reqs)

    def chunk_budget(self, num_active: int, chunks: Sequence[int]) -> int:
        """Deprecated: the number of ``chunks`` that ``select`` runs."""
        return _deprecated_chunk_budget(self, num_active, chunks)


@dataclasses.dataclass(frozen=True)
class TokenBudgetAdmission:
    """Chunked admission under a per-step token budget.

    Decode always runs and eats ``num_active`` tokens of the budget; pending
    prefills advance in FIFO order on the leftover: the prefix of chunks
    whose sizes fit ``budget - num_active``. An idle engine
    (``num_active == 0``) bypasses the gate, which is also the progress
    guarantee: decode drains slots until the leftover covers the head chunk.
    """

    chunk: int
    budget: int
    bucket_policy: object = "pow2"

    def __post_init__(self):
        if self.chunk <= 0:
            raise ValueError("TokenBudgetAdmission.chunk must be a "
                             "positive token count")
        if self.budget <= 0:
            raise ValueError("TokenBudgetAdmission.budget must be a "
                             "positive token count")

    def pad(self, prompt_len: int) -> int:
        return make_bucketer(self.bucket_policy)(prompt_len)

    def select(self, num_active: int,
               reqs: Sequence[RequestSpec]) -> tuple[int, ...]:
        if num_active == 0:
            return _fifo_order(reqs)
        left = self.budget - num_active
        k = 0
        for r in reqs:
            if r.chunk > left:
                break
            left -= r.chunk
            k += 1
        return tuple(range(k))

    def order(self, reqs: Sequence[RequestSpec]) -> tuple[int, ...]:
        return _fifo_order(reqs)

    def chunk_budget(self, num_active: int, chunks: Sequence[int]) -> int:
        """Deprecated: the number of ``chunks`` that ``select`` runs."""
        return _deprecated_chunk_budget(self, num_active, chunks)


@dataclasses.dataclass(frozen=True)
class EdfAdmission:
    """Deadline-aware token-budget admission: earliest deadline first within
    the chunk budget, starvation-free through aging.

    Pending chunks are ranked by effective deadline ``min(deadline,
    arrival + age_limit)``, ties by arrival, then submission order, so a
    request without a deadline competes as if due ``age_limit`` steps after
    it arrived. Selection is work-conserving: chunks are taken greedily in
    that order while they fit ``budget - num_active``, and one that does not
    fit is skipped, not blocking. ``budget=None`` runs every due chunk, in
    deadline order; an idle engine bypasses the budget.

    Shed mode (``shed=True``): ``shed_reason`` rejects a submit when the
    queue already holds ``queue_cap`` requests, or when its deadline is
    provably unattainable (see ``shed_reason``).
    """

    chunk: int
    budget: int | None = None
    bucket_policy: object = "pow2"
    age_limit: float = 256.0
    shed: bool = False
    queue_cap: int | None = None

    def __post_init__(self):
        if self.chunk <= 0:
            raise ValueError("EdfAdmission.chunk must be a positive token "
                             "count")
        if self.budget is not None and self.budget <= 0:
            raise ValueError("EdfAdmission.budget must be a positive "
                             "token count")
        if not self.age_limit > 0:
            raise ValueError("EdfAdmission.age_limit must be a positive "
                             "step count (it is the starvation bound)")
        if self.queue_cap is not None and self.queue_cap < 1:
            raise ValueError("EdfAdmission.queue_cap must be >= 1 "
                             f"(got {self.queue_cap}); use None for "
                             "an unbounded queue")

    def pad(self, prompt_len: int) -> int:
        return make_bucketer(self.bucket_policy)(prompt_len)

    def _eff(self, r: RequestSpec) -> tuple[float, float]:
        return (min(r.deadline, r.arrival + self.age_limit), r.arrival)

    def _rank(self, reqs: Sequence[RequestSpec]) -> list[int]:
        return sorted(range(len(reqs)), key=lambda i: (*self._eff(reqs[i]), i))

    def select(self, num_active: int,
               reqs: Sequence[RequestSpec]) -> tuple[int, ...]:
        ranked = self._rank(reqs)
        if self.budget is None or num_active == 0:
            return tuple(ranked)
        left = self.budget - num_active
        take = []
        for i in ranked:
            if reqs[i].chunk <= left:
                take.append(i)
                left -= reqs[i].chunk
        return tuple(take)

    def order(self, reqs: Sequence[RequestSpec]) -> tuple[int, ...]:
        return tuple(self._rank(reqs))

    def shed_reason(self, spec: RequestSpec,
                    queued: Sequence[RequestSpec],
                    num_active: int = 0) -> str | None:
        """The reason to reject ``spec`` given the current queue, or None to
        admit.

        The deadline trigger is a lower bound on time to first token:
        prefill needs at least ``ceil(work / budget)`` engine steps, where
        ``work`` counts the new prompt plus every queued prompt ranked at or
        ahead of it. Decode's share of the budget, padding and slot
        contention are ignored (each only makes reality slower), so a shed
        is provable. Unbudgeted policies only enforce ``queue_cap``."""
        if not self.shed:
            return None
        if self.queue_cap is not None and len(queued) >= self.queue_cap:
            return (f"queue_cap: {len(queued)} requests queued >= "
                    f"queue_cap {self.queue_cap}")
        if self.budget is None or not math.isfinite(spec.deadline):
            return None
        mine = self._eff(spec)
        work = spec.prompt_len + sum(
            r.prompt_len for r in queued if self._eff(r) <= mine)
        steps = math.ceil(work / self.budget)
        if spec.arrival + steps > spec.deadline:
            return (f"deadline: first token needs >= {steps} steps of the "
                    f"full prefill budget {self.budget} ({work} prompt "
                    "tokens at or ahead of this deadline), but the "
                    f"deadline is {spec.deadline - spec.arrival:g} steps "
                    "after arrival")
        return None

    def chunk_budget(self, num_active: int, chunks: Sequence[int]) -> int:
        """Deprecated: the number of ``chunks`` that ``select`` runs."""
        return _deprecated_chunk_budget(self, num_active, chunks)


class _LegacyAdmission:
    """The shim of a policy that implements only the deprecated int-based
    ``chunk_budget``: ``select`` forwards the bare chunk sizes and admits
    the returned prefix in arrival order. Made by ``coerce_admission``."""

    def __init__(self, policy):
        self._policy = policy
        self.chunk = getattr(policy, "chunk", None)
        self.budget = getattr(policy, "budget", None)
        self.bucket_policy = getattr(policy, "bucket_policy", "pow2")

    def pad(self, prompt_len: int) -> int:
        return self._policy.pad(prompt_len)

    def select(self, num_active: int,
               reqs: Sequence[RequestSpec]) -> tuple[int, ...]:
        k = self._policy.chunk_budget(num_active, [r.chunk for r in reqs])
        return tuple(range(min(int(k), len(reqs))))

    def order(self, reqs: Sequence[RequestSpec]) -> tuple[int, ...]:
        return _fifo_order(reqs)


def coerce_admission(policy, owner: str = "EngineConfig"):
    """``policy`` as a ``select``-based ``AdmissionPolicy``: a policy with
    ``select`` passes through; one with only the deprecated
    ``chunk_budget`` is wrapped in ``_LegacyAdmission`` with one
    ``DeprecationWarning`` (per call: ``EngineConfig.resolve_admission``
    caches the result, so an engine warns once); anything else raises
    ``TypeError``."""
    if hasattr(policy, "select"):
        return policy
    if hasattr(policy, "chunk_budget"):
        warnings.warn(
            f"{owner}: admission policy {type(policy).__name__} only "
            "implements the deprecated int-based chunk_budget(num_active, "
            "chunks) — implement select(num_active, reqs) over "
            "repro_torch.serving.RequestSpec objects instead",
            DeprecationWarning, stacklevel=3)
        return _LegacyAdmission(policy)
    raise TypeError(
        f"{owner}: {type(policy).__name__} is not an admission policy "
        "(needs select(num_active, reqs) — see "
        "repro_torch.serving.AdmissionPolicy)")


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's SLO targets, in engine-step units (the clock of
    ``Request.arrival``), and for the multi-tenant engine its model, params
    and expert pairing. ``ttft_p95`` becomes each request's deadline
    (``arrival + ttft_p95``) at submit; ``tpot_p95`` is reported, not
    scheduled on; ``rate_share`` is the tenant's fraction of the step token
    budget (``scale_admission``). Shares across one config sum to <= 1.

    ``model``/``params``/``pair`` let ``MultiTenantContinuousEngine`` be
    built from ``EngineConfig(tenants=...)`` alone, and ``admit_tenant``
    take the same validated type. ``params`` are in the LOGICAL
    (unpermuted) frame; ``pair`` is the slot->expert placement the engine
    realises (identity when None)."""

    name: str | None = None
    ttft_p95: float | None = None
    tpot_p95: float | None = None
    rate_share: float | None = None
    model: object = None
    params: object = None
    pair: tuple[int, ...] | None = None

    def __post_init__(self):
        for field in ("ttft_p95", "tpot_p95"):
            v = getattr(self, field)
            if v is not None and not v > 0:
                raise ValueError(f"{field} must be a positive engine-step "
                                 f"count, got {v!r}")
        if self.rate_share is not None and not 0 < self.rate_share <= 1:
            raise ValueError("rate_share must be in (0, 1] — it is the "
                             "tenant's fraction of the step token budget, "
                             f"got {self.rate_share!r}")
        if self.pair is not None:
            object.__setattr__(self, "pair",
                               tuple(int(x) for x in self.pair))
        if self.params is not None and self.model is None:
            raise ValueError("TenantSpec.params without model — the engine "
                             "needs both to host the tenant")

    def deadline(self, arrival: float) -> float:
        """Absolute deadline of a request arriving at ``arrival``
        (``math.inf`` when the tenant declares no TTFT target)."""
        if self.ttft_p95 is None:
            return math.inf
        return arrival + self.ttft_p95


def scale_admission(policy, rate_share: float | None):
    """Per-tenant view of a budgeted admission policy: its budget scaled by
    ``rate_share`` and floored at one chunk. Unbudgeted policies and
    ``None`` shares pass through unchanged."""
    budget = getattr(policy, "budget", None)
    if (rate_share is None or budget is None
            or not dataclasses.is_dataclass(policy)):
        return policy
    chunk = getattr(policy, "chunk", None) or 1
    return dataclasses.replace(
        policy, budget=max(int(chunk), int(round(budget * rate_share))))


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Scheduling knobs of the continuous engine.

    ``prefill_len``: fixed left-pad length of every prompt (None = bucket
    per the admission policy). ``admission`` is any ``AdmissionPolicy``;
    ``prefill_chunk``/``step_token_budget``/``bucket_policy`` are the
    shorthand for the stock policies (set one or the other, not both).
    ``prefill_pool = K`` keeps up to K chunked prefills in flight; each
    engine step runs all their picked chunks (each a batch-1 call) and the
    decode. ``tenants``: at most one ``TenantSpec`` for ``ContinuousEngine``;
    the colocated and multi-tenant engines give one to each pool.
    ``kernels``: ``False`` (plain dense path), ``True`` (default
    ``KernelConfig``) or a ``KernelConfig``, applied by ``kernelize``.
    ``jit``: the reference's compile switch (``False`` runs its steps
    eagerly); the port's steps always run eagerly, so it changes nothing
    here and is kept so that a reference config carries over.
    ``step_wrapper`` wraps every step callable the engine runs (prefill,
    chunk, decode, pool, lockstep decode); fault injection times and
    screens steps through it. ``telemetry`` attaches a
    ``serving.Telemetry`` hub: step callables become spans (outermost,
    around ``step_wrapper``), shed, re-plan, fault and adoption events
    publish to its bus and its metrics fill in; None (default) composes no
    wrapper and does no per-step work. The colocated and multi-tenant
    pools share the hub. ``event_capacity`` bounds ``shed_events``
    (drop-oldest).
    """

    prefill_len: int | None = None
    prefill_chunk: int | None = None
    step_token_budget: int | None = None
    bucket_policy: object = "pow2"
    prefill_pool: int = 1
    admission: AdmissionPolicy | None = None
    tenants: tuple[TenantSpec, ...] = ()
    kernels: object = False          # bool | KernelConfig
    jit: bool = True
    step_wrapper: Callable | None = None
    telemetry: object = None         # Telemetry | None
    event_capacity: int = 4096

    def __post_init__(self):
        if self.prefill_len is not None and self.prefill_len <= 0:
            raise ValueError("prefill_len must be a positive token count")
        make_bucketer(self.bucket_policy)      # raises on an unknown policy
        object.__setattr__(self, "tenants", tuple(self.tenants))
        if self.event_capacity < 1:
            raise ValueError("event_capacity must be >= 1")
        for t in self.tenants:
            if not isinstance(t, TenantSpec):
                raise ValueError(f"tenants must be TenantSpec entries, "
                                 f"got {type(t).__name__}")
        shares = [t.rate_share for t in self.tenants
                  if t.rate_share is not None]
        if sum(shares) > 1 + 1e-9:
            raise ValueError(f"tenant rate_shares sum to {sum(shares)} > 1 "
                             "— shares are fractions of ONE step token "
                             "budget")
        if self.admission is not None:
            if (self.prefill_chunk is not None
                    or self.step_token_budget is not None):
                raise ValueError(
                    "admission= replaces the prefill_chunk/step_token_budget "
                    "shorthand — configure chunking inside the policy")
            if self.bucket_policy != "pow2":
                raise ValueError(
                    "with admission= set, pass bucket_policy inside the "
                    "admission policy (the config-level field would be "
                    "silently ignored)")
        if self.prefill_chunk is not None and self.prefill_chunk <= 0:
            raise ValueError("prefill_chunk must be a positive token count")
        if self.step_token_budget is not None and self.prefill_chunk is None:
            raise ValueError(
                "step_token_budget only gates CHUNKED prefill scheduling — "
                "one-shot admission absorbs whole prompts regardless; set "
                "prefill_chunk to give the budget something to schedule")
        if self.prefill_pool < 1:
            raise ValueError("prefill_pool must be >= 1")
        if self.prefill_pool > 1 and self.resolve_admission().chunk is None:
            raise ValueError(
                "prefill_pool > 1 pools CHUNKED prefills — one-shot "
                "admission has nothing to interleave; set prefill_chunk "
                "(or a chunked admission policy)")

    def resolve_admission(self) -> AdmissionPolicy:
        """The admission policy this config realizes (an explicit
        ``admission`` wins, through ``coerce_admission``; else the
        shorthand's stock policy), cached on the config, so a shimmed
        ``chunk_budget`` policy warns once."""
        cached = getattr(self, "_resolved_admission", None)
        if cached is not None:
            return cached
        if self.admission is not None:
            resolved = coerce_admission(self.admission)
        elif self.prefill_chunk is None:
            resolved = FifoAdmission(bucket_policy=self.bucket_policy)
        elif self.step_token_budget is None:
            resolved = LengthBucketedAdmission(
                chunk=self.prefill_chunk, bucket_policy=self.bucket_policy)
        else:
            resolved = TokenBudgetAdmission(
                chunk=self.prefill_chunk, budget=self.step_token_budget,
                bucket_policy=self.bucket_policy)
        object.__setattr__(self, "_resolved_admission", resolved)
        return resolved

    def kernelize(self, model):
        """Route ``model`` through the kernel hot path per ``self.kernels``
        (no-op when False)."""
        return model.with_kernels(self.kernels)


# The reference's old per-engine constructor keywords, each an
# ``EngineConfig`` field.
_LEGACY_KEYS = ("prefill_len", "prefill_chunk", "step_token_budget",
                "bucket_policy", "kernels", "jit", "step_wrapper")


def coerce_config(config: EngineConfig | None, kwargs: dict, owner: str,
                  strict: bool = True) -> EngineConfig:
    """The deprecated-keyword shim of the engine constructors: pop the
    ``_LEGACY_KEYS`` out of ``kwargs``, fold them into an ``EngineConfig``
    with one ``DeprecationWarning``, and return the effective config.

    ``strict=True`` (the engine constructors) raises ``TypeError`` on any
    key left over; the ``Distributed*`` engines coerce first with
    ``strict=False``, because their ``kwargs`` still carry arguments for
    the parent constructor, which then runs the strict pass. ``config``
    together with legacy keywords raises ``ValueError``."""
    legacy = {k: kwargs.pop(k) for k in _LEGACY_KEYS if k in kwargs}
    if strict and kwargs:
        raise TypeError(f"{owner}: unexpected keyword argument(s) "
                        f"{sorted(kwargs)}")
    if not legacy:
        return config if config is not None else EngineConfig()
    if config is not None:
        raise ValueError(
            f"{owner}: pass either config=EngineConfig(...) or the "
            f"deprecated keyword(s) {sorted(legacy)}, not both")
    warnings.warn(
        f"{owner}({', '.join(sorted(legacy))}=...) is deprecated — pass "
        "config=EngineConfig(...) (repro_torch.serving.EngineConfig)",
        DeprecationWarning, stacklevel=3)
    return EngineConfig(**legacy)
