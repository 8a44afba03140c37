"""Continuous-batching engine (port of ``ContinuousEngine`` and its helpers
from ``repro/serving/engine.py``).

``ContinuousEngine`` owns a request queue plus ``batch_slots`` decode slots
over a shared per-slot KV cache (``init_cache(per_slot_len=True)``). Each
step admits queued requests, then decodes every slot once and evicts
finished requests. Admission is one-shot by default (a batch-1 prefill
copied into the slot's cache row, ``Model.prefill_slot``).

Chunked prefill (``EngineConfig(prefill_chunk=C)`` or a chunked
``AdmissionPolicy``): a prompt is absorbed at most C tokens per engine step
straight into its slot's row (``Model.prefill_chunk_slot``); between
chunks the decode step freezes that row (``row_mask``). The policy's
``select`` decides which due chunks run each step: decode always runs;
``TokenBudgetAdmission`` feeds chunks from the leftover budget in FIFO
order, ``EdfAdmission`` by earliest effective deadline.

Prefill pool (``EngineConfig(prefill_pool=K)``): up to K chunked prefills
in flight. Each step runs the picked chunks in the policy's order, each as
its own batch-1 call (MoE capacity is per token group, so batching them
would change the routing), then the decode with the pending slots masked,
then the decode's bookkeeping, and last the first tokens of prompts that
finished. The reference fuses the same sub-calls into one jitted program;
here they run in sequence on the current stream.

The reference's semantics are kept exactly, because greedy token streams
are compared with it: prompts are left-padded with 0 to their bucket (pad
tokens are not masked); vacant slots decode too, so their stale tokens take
part in MoE routing and capacity at T = batch_slots (their cache rows and
lengths stay frozen); and the current-token buffer is replaced wholesale by
the argmax over all rows after each decode. Chunk bookkeeping (offsets,
padded tokens) stays on the host.

Live routing stats (``monitor=TrafficMonitor(...)``): every decode step,
one-shot prefill and chunk also returns its per-layer expert routing counts
(``Model.decode_step_stats``, ``collect_moe_stats=True``), which are copied
to the host and folded into the monitor, feeding the re-planner
(``serving.monitor``). Each copy waits for the call that made the counts.
Prefill counts drop the left-pad positions.

Placement (``adopt_assignment``, ``adopt``): an expert->device assignment
is realised by re-seating the expert weights and the router columns in
place (``colocated.reseat_pairing``), so the function, and every emitted
token, stays the same.

The cache is updated in place (the reference donates it to a jitted step).
Replication, telemetry and fault tolerance (``checkpoint``/``restore``/
``requeue``) are not ported yet.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from ..core.errors import PlanError
from ..models import Model
from .config import EngineConfig, RequestSpec, ShedEvent
from .events import RingBuffer

__all__ = ["Request", "poisson_requests", "serve_stream", "ContinuousEngine"]


@dataclasses.dataclass
class Request:
    prompt: Sequence[int]
    max_new_tokens: int = 16
    arrival: float = 0.0                 # engine-step time of arrival
    # Absolute deadline (engine-step time) for deadline-aware admission.
    # None = stamped at submit from the engine's TenantSpec (math.inf when
    # there is no TTFT target).
    deadline: float | None = None
    tenant: object = None                # opaque tenant id for the policy
    out_tokens: list = dataclasses.field(default_factory=list)


def poisson_requests(rng, n: int, rate: float, vocab: int, prompt_len: int,
                     max_new_lo: int, max_new_hi: int) -> list[Request]:
    """n requests with Exp(1/rate) inter-arrival gaps (a Poisson process in
    decode-step time units) and uniform output lengths in
    [max_new_lo, max_new_hi]. ``rng`` is a numpy Generator."""
    t = 0.0
    reqs = []
    for _ in range(n):
        t += float(rng.exponential(1.0 / rate)) if rate > 0 else 0.0
        reqs.append(Request(
            prompt=list(rng.integers(1, vocab, prompt_len)),
            max_new_tokens=int(rng.integers(max_new_lo, max_new_hi + 1)),
            arrival=t))
    return reqs


def serve_stream(step_fn, pools) -> None:
    """Arrival-clock driver. ``pools``: (engine, requests) pairs. Each tick
    submits every request whose ``arrival`` has passed (same-arrival
    requests in list order), runs one ``step_fn()``, and jumps the clock
    over idle gaps when nothing is active or pending but requests are still
    due."""
    streams = [[eng, sorted(reqs, key=lambda r: r.arrival), 0]
               for eng, reqs in pools]
    t = 0.0
    while any(i < len(p) or e.queue or e.num_active or e.num_pending
              for e, p, i in streams):
        for s in streams:
            eng, pend, i = s
            while i < len(pend) and pend[i].arrival <= t:
                eng.submit(pend[i])
                i += 1
            s[2] = i
        due = [p[i].arrival for _, p, i in streams if i < len(p)]
        if not step_fn() and due:
            t = max(t + 1.0, min(due))
        else:
            t += 1.0


class ContinuousEngine:
    """Continuous-batching scheduler over ``batch_slots`` decode slots.

    The slot state machine lives on the host (``queue``, ``slots`` and the
    in-flight chunked prefills); the device holds the shared cache and the
    (B, 1) current-token buffer. ``prefills`` counts model prefill calls,
    one-shot and chunk alike; ``decode_steps`` counts decode calls.
    ``monitor``: an optional ``TrafficMonitor`` fed with the routing counts
    of every call. ``assignment``: the expert->device map realised in
    ``params`` (identity until one is adopted; None for a dense model).
    """

    def __init__(self, model: Model, params, batch_slots: int,
                 cache_cap: int, config: EngineConfig | None = None,
                 monitor=None):
        config = config if config is not None else EngineConfig()
        self.config = config
        model = config.kernelize(model)
        self.model = model
        self.params = params
        self.device = model.device
        self.batch_slots = batch_slots
        self.cache_cap = cache_cap
        self.admission = config.resolve_admission()
        if len(config.tenants) > 1:
            raise ValueError(
                f"{type(self).__name__} hosts one tenant; config.tenants "
                f"has {len(config.tenants)}")
        self.tenant_spec = config.tenants[0] if config.tenants else None
        self.prefill_len = config.prefill_len
        self.prefill_chunk = self.admission.chunk
        self._pool_size = config.prefill_pool
        self.monitor = monitor
        self.assignment = (list(range(model.cfg.moe.n_experts))
                           if model.cfg.moe is not None else None)
        self.cache = model.init_cache(batch_slots, cache_cap,
                                      per_slot_len=True)
        self.tokens = torch.zeros((batch_slots, 1), dtype=torch.long,
                                  device=self.device)
        self.queue: collections.deque[Request] = collections.deque()
        self.slots: list[Request | None] = [None] * batch_slots
        # In-flight chunked prefills, in arrival order: [req, slot,
        # padded_toks, done]; ``done`` is the host-side chunk offset.
        self._pending: list[list] = []
        self.decode_steps = 0
        self.prefills = 0
        # Rejected submits under shed-mode admission, drop-oldest.
        self.shed_events = RingBuffer(config.event_capacity)

    def adopt_assignment(self, expert_to_device) -> None:
        """Adopt an exclusive-scenario expert->device assignment (Thm 5.1),
        placement-only: device slot d's expert weights are re-seated in
        place so expert e sits on ``expert_to_device[e]``, and the router
        columns follow (``reseat_pairing``), so the composed function and
        every emitted token are unchanged. The monitor's stats frame
        follows the new slot->expert map. Here a "device slot" is a
        position along the expert axis, as expert-parallel sharding places
        contiguous expert blocks."""
        from .colocated import inverse_pair, reseat_pairing
        if self.assignment is None:
            raise PlanError("adopt_assignment needs an MoE model "
                            "(expert->device assignment is per expert)")
        e2d = [int(x) for x in np.asarray(expert_to_device).tolist()]
        n_e = len(self.assignment)
        if sorted(e2d) != list(range(n_e)):
            raise PlanError(
                f"expert_to_device {e2d} is not a permutation of "
                f"0..{n_e - 1} — exclusive assignment places one expert "
                "per device")
        if e2d == self.assignment:
            return
        new_pair = inverse_pair(e2d)              # device slot -> expert
        self.params = reseat_pairing(self.params,
                                     inverse_pair(self.assignment), new_pair,
                                     self.model.cfg)
        self.assignment = e2d
        if self.monitor is not None:
            self.monitor.slot_to_expert = new_pair

    def adopt(self, plan) -> None:
        """Adopt a placement mid-stream: an exclusive-scenario ``Plan`` (its
        ``expert_to_device``), or None (no replicas: nothing to drop).
        Replicated plans and bare host maps wait for the replication slice
        of the port and raise."""
        if plan is None:
            return
        if not hasattr(plan, "schedules") or plan.replication is not None:
            raise NotImplementedError(
                "hot-expert replication is not ported yet: this engine "
                "adopts expert->device assignments only")
        if (plan.pair is None and plan.groups is None
                and self.assignment is not None
                and len(plan.expert_to_device) == len(self.assignment)):
            self.adopt_assignment(plan.expert_to_device)

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self.slots)

    @property
    def num_pending(self) -> int:
        """In-flight chunked prefills (up to ``config.prefill_pool``)."""
        return len(self._pending)

    def submit(self, req: Request) -> ShedEvent | None:
        """Queue ``req``, or under shed-mode admission reject it: the typed
        ``ShedEvent`` is returned and appended to ``shed_events``."""
        # The final per-slot length is pad(prompt) + max_new_tokens - 1
        # (the last emitted token is never written back).
        p = self._bucket(len(req.prompt))
        need = p + max(req.max_new_tokens - 1, 0)
        if need > self.cache_cap:
            raise ValueError(
                f"prompt + generation needs {need} cache slots, "
                f"capacity is {self.cache_cap}")
        if (self.prefill_chunk is not None
                and not self.model.supports_chunked_prefill(
                    p, self.cache_cap)):
            raise ValueError(
                f"{self.model.cfg.arch_id}: a {p}-token prefill cannot be "
                "chunked — use prefill_chunk=None for this engine")
        if req.deadline is None:
            req.deadline = (self.tenant_spec.deadline(req.arrival)
                            if self.tenant_spec is not None else math.inf)
        if req.tenant is None and self.tenant_spec is not None:
            req.tenant = self.tenant_spec.name
        shed_reason = getattr(self.admission, "shed_reason", None)
        if shed_reason is not None:
            reason = shed_reason(self._queue_spec(req),
                                 [self._queue_spec(r) for r in self.queue],
                                 self.num_active + self.num_pending)
            if reason is not None:
                ev = ShedEvent(tenant=req.tenant, arrival=req.arrival,
                               reason=reason, request=req)
                self.shed_events.append(ev)
                return ev
        self.queue.append(req)
        return None

    def _bucket(self, n: int) -> int:
        if self.prefill_len is not None:
            if n > self.prefill_len:
                raise ValueError(f"prompt len {n} > prefill_len "
                                 f"{self.prefill_len}")
            return self.prefill_len
        p = self.admission.pad(n)
        if p < n:
            raise ValueError(f"bucket policy shrank {n} to {p}")
        p = min(p, self.cache_cap)
        if self.prefill_chunk is not None:
            # Clamp the pad to the longest chunkable prompt, so only
            # prompts that are themselves too long are refused.
            lim = self.model.chunkable_len(self.cache_cap)
            if lim is not None and n <= lim:
                p = min(p, lim)
        return p

    def _free_slot(self) -> int | None:
        """First free slot not reserved by an in-flight prefill."""
        reserved = {p[1] for p in self._pending}
        for i, r in enumerate(self.slots):
            if r is None and i not in reserved:
                return i
        return None

    def _spec(self, r: Request, chunk: int) -> RequestSpec:
        """The admission policy's view of one pending request."""
        return RequestSpec(
            chunk=int(chunk), prompt_len=len(r.prompt), arrival=r.arrival,
            deadline=math.inf if r.deadline is None else r.deadline,
            tenant=r.tenant)

    def _queue_spec(self, r: Request) -> RequestSpec:
        """The spec of a queued request: its first chunk (the whole padded
        prompt under one-shot admission)."""
        b = self._bucket(len(r.prompt))
        return self._spec(r, min(self.prefill_chunk or b, b))

    @staticmethod
    def _check_selection(order, n: int) -> list[int]:
        """A policy's select()/order() result: unique indices in range, or
        ValueError (a buggy policy would run one chunk twice)."""
        idx = [int(i) for i in order]
        if len(set(idx)) != len(idx) or any(not 0 <= i < n for i in idx):
            raise ValueError(
                f"admission policy returned invalid indices {idx} for "
                f"{n} pending requests (need unique ints in range)")
        return idx

    def _pop_queue(self) -> Request:
        """Next queued request per the policy's queue discipline (FIFO for
        the stock policies, earliest effective deadline for EDF)."""
        if len(self.queue) > 1:
            specs = [self._queue_spec(r) for r in self.queue]
            order = self._check_selection(self.admission.order(specs),
                                          len(specs))
            if order:
                r = self.queue[order[0]]
                del self.queue[order[0]]
                return r
        return self.queue.popleft()

    def _padded(self, r: Request) -> np.ndarray:
        """(1, bucket) host tokens of ``r``'s prompt, left-padded with 0."""
        p = self._bucket(len(r.prompt))
        toks = np.zeros((1, p), np.int64)
        toks[0, p - len(r.prompt):] = r.prompt
        return toks

    def _finish_admission(self, r: Request, slot: int, logits) -> None:
        """Emit the first token and occupy the slot (unless already done)."""
        tok0 = int(torch.argmax(logits[0, -1, : self.model.cfg.vocab]))
        if r.max_new_tokens > 0:
            r.out_tokens.append(tok0)
        if len(r.out_tokens) < r.max_new_tokens:
            self.slots[slot] = r
            self.tokens[slot, 0] = tok0

    def _admit(self) -> None:
        """Drain the queue into free slots, one batch-1 prefill each, in the
        policy's queue order."""
        while self.queue and None in self.slots:
            slot = self.slots.index(None)
            r = self._pop_queue()
            padded = self._padded(r)
            out = self.model.prefill_slot(
                self.params, {"tokens": torch.from_numpy(padded).to(
                    self.device)}, self.cache, slot, cap=self.cache_cap,
                collect_moe_stats=self.monitor is not None)
            self.prefills += 1
            if self.monitor is not None:
                self._observe_prefill(out[2],
                                      pad=padded.shape[1] - len(r.prompt))
            self._finish_admission(r, slot, out[0])

    def _admit_tick(self) -> bool:
        """One tick of admission work. Returns True iff chunked prefill
        progressed (one-shot admissions show in ``num_active``)."""
        if self.prefill_chunk is None:
            self._admit()
            return False
        if self._pool_size > 1:
            return self._pool_tick(fuse_decode=False)
        return self._prefill_tick()

    def _start_pending(self, slot: int) -> None:
        """Pop the policy's next queued request into a reserved slot as an
        in-flight prefill."""
        r = self._pop_queue()
        self._pending.append([r, slot, self._padded(r), 0])

    def _run_chunk(self, p: list, c: int):
        """Run the next ``c`` tokens of pending prefill ``p`` into its slot
        row. The first chunk starts the row from zero; later ones resume at
        its fill level. Returns (logits, routing): ``routing`` is the
        chunk's (stats, pad) for ``_observe_prefill`` under a monitor, else
        None."""
        r, slot, toks, done = p
        chunk = torch.from_numpy(toks[:, done:done + c]).to(self.device)
        out = self.model.prefill_chunk_slot(
            self.params, {"tokens": chunk}, self.cache, slot,
            first=done == 0, cap=self.cache_cap,
            collect_moe_stats=self.monitor is not None)
        self.prefills += 1
        p[3] = done + c
        # The chunk covers padded positions [done, done + c); the left pad
        # spans [0, total - len(prompt)) of the padded prompt.
        routing = (None if self.monitor is None
                   else (out[2], toks.shape[1] - len(r.prompt) - done))
        return out[0], routing

    def _prefill_tick(self) -> bool:
        """Serialised chunked admission (``prefill_pool=1``): start or
        advance the single in-flight prefill by at most one chunk, as the
        admission policy allows."""
        if not self._pending:
            slot = self._free_slot()
            if not self.queue or slot is None:
                return False
            self._start_pending(slot)
        p = self._pending[0]
        c = min(self.prefill_chunk, p[2].shape[1] - p[3])
        # Decode always runs and eats num_active tokens of any budget; the
        # chunk runs only when the policy admits it.
        if not self.admission.select(self.num_active, [self._spec(p[0], c)]):
            return False
        logits, routing = self._run_chunk(p, c)
        if routing is not None:
            self._observe_prefill(*routing)
        if p[3] >= p[2].shape[1]:
            self._pending.pop(0)
            self._finish_admission(p[0], p[1], logits)
        return True

    def _pool_tick(self, fuse_decode: bool) -> bool:
        """Pooled chunked admission (``prefill_pool=K``): top the pool up in
        the policy's queue order, run every picked chunk in the policy's run
        order and, when ``fuse_decode`` is set and slots are occupied, the
        decode over every slot (pending ones masked).

        Order matters: ``_postdecode`` replaces ``self.tokens`` wholesale
        with this step's argmax, so it runs before ``_finish_admission``
        writes a newly admitted slot's first token. Under a monitor the
        decode's counts are observed first and then the chunks', as in the
        reference."""
        while len(self._pending) < self._pool_size and self.queue:
            slot = self._free_slot()
            if slot is None:
                break
            self._start_pending(slot)
        chunks = [min(self.prefill_chunk, p[2].shape[1] - p[3])
                  for p in self._pending]
        specs = [self._spec(p[0], c) for p, c in zip(self._pending, chunks)]
        picked = self._check_selection(
            self.admission.select(self.num_active, specs), len(specs))
        decode = fuse_decode and self.num_active > 0
        if not picked and not decode:
            return False
        finished, routings = [], []
        for i in picked:
            p = self._pending[i]
            logits, routing = self._run_chunk(p, chunks[i])
            routings.append(routing)
            if p[3] >= p[2].shape[1]:
                finished.append((p, logits))
        if decode:
            logits = self._decode_all()
            self.decode_steps += 1
            self._postdecode(logits)
        for routing in routings:
            if routing is not None:
                self._observe_prefill(*routing)
        for p, logits in finished:
            self._pending.remove(p)
            self._finish_admission(p[0], p[1], logits)
        return True

    def _decode_all(self):
        """One fixed-shape decode over every slot; vacant rows and rows of
        in-flight prefills keep their cache state and fill level
        (``row_mask``). Under a monitor the step's routing counts are
        observed, vacant rows masked out."""
        mask = np.array([r is not None for r in self.slots], bool)
        row_mask = torch.from_numpy(mask).to(self.device)
        if self.monitor is None:
            logits, self.cache = self.model.decode_step(
                self.params, self.tokens, self.cache, row_mask)
            return logits
        logits, self.cache, stats = self.model.decode_step_stats(
            self.params, self.tokens, self.cache, row_mask)
        self._observe_decode_routing(stats, mask)
        return logits

    def _observe_decode_routing(self, stats, mask) -> None:
        """Fold one decode step's (L, B, E) routing counts into the monitor
        (host copy; ``mask`` (B,) bool marks the occupied rows)."""
        self.monitor.observe(stats.cpu().numpy(), mask)

    def _observe_prefill(self, stats, pad: int) -> None:
        """Fold prefill routing counts (L, 1, S, E) into the monitor,
        dropping the first ``pad`` positions (left padding routes token 0
        every time and would skew the popularity estimate)."""
        real = stats.cpu().numpy()[:, :, max(pad, 0):, :]
        if real.shape[2]:
            self.monitor.observe(real.sum(axis=2))

    def _postdecode(self, logits) -> None:
        """Emit one token per occupied slot; evict finished requests."""
        nxt = torch.argmax(logits[:, :, : self.model.cfg.vocab], dim=-1)
        self.tokens = nxt
        host = nxt.cpu().numpy()
        for i, r in enumerate(self.slots):
            if r is None:
                continue
            r.out_tokens.append(int(host[i, 0]))
            if len(r.out_tokens) >= r.max_new_tokens:
                self.slots[i] = None

    def step(self) -> bool:
        """Admit (whole prefills, or policy-admitted chunks), then decode
        all slots once. Returns False when idle. (The reference wraps
        ``_step_impl`` in telemetry spans here; the port has no telemetry
        yet.)"""
        return self._step_impl()

    def _step_impl(self) -> bool:
        if self._pool_size > 1:
            return self._pool_tick(fuse_decode=True)
        worked = self._admit_tick()
        if self.num_active == 0:
            return worked
        logits = self._decode_all()
        self.decode_steps += 1
        self._postdecode(logits)
        return True

    def serve(self, reqs: list[Request]) -> list[Request]:
        """Run a request stream to completion, honoring ``arrival`` times
        (in engine steps; same-step arrivals are admitted in list order)."""
        serve_stream(self.step, [(self, reqs)])
        return reqs
