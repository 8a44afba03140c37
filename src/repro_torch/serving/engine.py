"""Serving engines: static fixed-batch and continuous batching (port of
``ServingEngine``, ``ContinuousEngine`` and their helpers from
``repro/serving/engine.py``).

``ServingEngine`` runs one fixed-shape batch to completion: prompts are
left-padded with 0 to a common length, prefilled together into a cache
with one scalar fill level, and the whole batch decodes greedily for
``max(max_new_tokens)`` steps. It is the baseline the continuous engine is
set against: with every request arriving at t = 0 and the same pad length,
the two emit identical streams.

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

Placement (``adopt_assignment``, ``adopt_replication``, ``adopt``): an
expert->device assignment is realised by re-seating the expert weights and
the router columns in place (``colocated.reseat_pairing``); a hot-expert
replication by re-laying the expert leaves out one (layer, weight kind)
slab at a time into the engine's own per-layer tensors
(``moe.relayout_moe_params``; the caller's params are never written).
Either way the function, and every emitted token, stays the same.

Step callables: every model call the scheduler makes (one-shot prefill,
chunk, decode, pool step) goes through ``EngineConfig.step_wrapper``
(innermost) and, when a telemetry hub is attached, its span wrapper
(outermost). Fault tolerance: ``checkpoint`` copies the cache and the token
buffer (the cache is written in place, so a snapshot must not alias it),
``restore`` copies them back, ``requeue`` evicts slots fail-stop.

The cache is updated in place (the reference donates it to a jitted step).
"""

from __future__ import annotations

import collections
import dataclasses
import math
from functools import partial
from typing import Sequence

import numpy as np
import torch

from ..bridge import map_tree
from ..core.errors import FaultError, PlanError
from ..models import Model
from .config import (EngineConfig, RequestSpec, ShedEvent, coerce_config,
                     make_bucketer)
from .events import RingBuffer
from .telemetry import STEP_BOUNDS, record_adoption, tree_leaves

__all__ = ["Request", "poisson_requests", "serve_stream", "ServingEngine",
           "ContinuousEngine", "refuse_encoder_decoder", "wrap_step_callable"]


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


def refuse_encoder_decoder(model: Model, engine: str) -> None:
    """Raise ValueError for an encoder-decoder: the continuous and
    colocated engines pass tokens only, and its encoder needs frames (the
    reference's engines pass none and fail with KeyError: 'frames')."""
    if model.cfg.is_encoder_decoder:
        raise ValueError(f"{model.cfg.arch_id} is an encoder-decoder: "
                         f"{engine} takes no frames; serve it with "
                         "ServingEngine(...).serve(reqs, frames)")


def wrap_step_callable(fn, name: str, config: EngineConfig,
                       tenant: str | None = None, rounds=None):
    """A step callable as every engine runs it: ``config.step_wrapper``
    innermost and, with a hub, its span wrapper ``name`` outermost, so the
    span covers the wrapped call. ``rounds`` (a callable returning the
    engine's current permutation rounds, or None) gives the span its
    ``dispatch_round`` sub-spans."""
    if config.step_wrapper is not None:
        fn = config.step_wrapper(fn)
    if config.telemetry is not None:
        fn = config.telemetry.wrap_step(fn, name, tenant=tenant,
                                        rounds=rounds)
    return fn


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


class ServingEngine:
    """Static batch serving over ``batch_slots`` rows of one cache with a
    scalar fill level. ``kernels`` (True or a ``KernelConfig``) routes the
    model through the kernel path, as ``EngineConfig(kernels=...)`` does
    for the continuous engine. ``src_len``: the source positions of an
    encoder-decoder's cross K/V; 0 sizes them from the frames at each
    ``serve`` (the reference's prefill replaces its empty cross cache with
    the encoder's K/V; the port writes its cache in place, so it sizes it
    first). ``decode_steps`` counts decode calls."""

    def __init__(self, model: Model, params, batch_slots: int,
                 cache_cap: int, src_len: int = 0, kernels=False):
        self.model = model.with_kernels(kernels)
        self.params = params
        self.device = self.model.device
        self.batch_slots = batch_slots
        self.cache_cap = cache_cap
        self.src_len = src_len
        self.decode_steps = 0

    def _pad_prompts(self, reqs: list[Request]) -> np.ndarray:
        plen = max(len(r.prompt) for r in reqs)
        toks = np.zeros((self.batch_slots, plen), np.int64)
        for i, r in enumerate(reqs):
            toks[i, plen - len(r.prompt):] = r.prompt    # left-pad with 0
        return toks

    def serve(self, reqs: list[Request], frames=None) -> list[Request]:
        """Run one batch of requests to completion (greedy decoding): one
        prefill, then ``max(max_new_tokens)`` decode steps over every row
        (rows past ``len(reqs)`` are all pad), each request keeping its
        first ``max_new_tokens`` tokens. ``frames``: an encoder-decoder's
        (batch_slots, S_src, frontend_dim) frame embeddings (numpy or a
        tensor); with ``src_len`` set, S_src must equal it."""
        if len(reqs) > self.batch_slots:
            raise ValueError("too many requests for the batch")
        model, vocab = self.model, self.model.cfg.vocab
        toks = torch.from_numpy(self._pad_prompts(reqs)).to(self.device)
        inputs = {"tokens": toks}
        src_len = self.src_len
        if frames is not None:
            inputs["frames"] = torch.as_tensor(frames).to(self.device)
            n_src = inputs["frames"].shape[1]
            if src_len and src_len != n_src:
                raise ValueError(f"frames of {n_src} positions for an "
                                 f"engine of src_len {src_len}")
            src_len = n_src
        cache = model.init_cache(self.batch_slots, self.cache_cap,
                                 src_len=src_len)
        logits, cache = model.prefill(self.params, inputs, cache)
        tok = torch.argmax(logits[:, -1:, :vocab], dim=-1)
        for _ in range(max(r.max_new_tokens for r in reqs)):
            host = tok.cpu().numpy()
            for i, r in enumerate(reqs):
                if len(r.out_tokens) < r.max_new_tokens:
                    r.out_tokens.append(int(host[i, 0]))
            logits, cache = model.decode_step(self.params, tok, cache)
            self.decode_steps += 1
            tok = torch.argmax(logits[:, :, :vocab], dim=-1)
        return reqs


class ContinuousEngine:
    """Continuous-batching scheduler over ``batch_slots`` decode slots.

    The slot state machine lives on the host (``queue``, ``slots`` and the
    in-flight chunked prefills); the device holds the shared cache and the
    (B, 1) current-token buffer. ``prefills`` counts model prefill calls,
    one-shot and chunk alike; ``decode_steps`` counts decode calls.
    ``monitor``: an optional ``TrafficMonitor`` fed with the routing counts
    of every call. ``assignment``: the expert->device map realised in
    ``params`` (identity until one is adopted; None for a dense model).
    ``model.replication``: the hot-expert layout realised in ``params``.
    """

    def __init__(self, model: Model, params, batch_slots: int,
                 cache_cap: int, config: EngineConfig | None = None,
                 monitor=None, **legacy):
        config = coerce_config(config, legacy, type(self).__name__)
        refuse_encoder_decoder(model, "ContinuousEngine")
        self.config = config
        model = config.kernelize(model)
        self.model = model
        self.params = params
        self.device = model.device
        self.batch_slots = batch_slots
        self.cache_cap = cache_cap
        self.admission = config.resolve_admission()
        # Prompts pad by the policy's bucket_policy, as the reference's
        # engine pads them (a shimmed chunk_budget policy's defaults to
        # "pow2", whatever its own ``pad`` says).
        self._bucketer = make_bucketer(self.admission.bucket_policy)
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
        self._telemetry = config.telemetry
        self._tenant_label = (self.tenant_spec.name
                              if self.tenant_spec is not None else "")
        self._build_steps()
        self.decode_steps = 0
        self.prefills = 0
        # Rejected submits under shed-mode admission, drop-oldest.
        self.shed_events = RingBuffer(config.event_capacity)

    def _build_steps(self) -> None:
        """(Re)build the step callables from ``self.model``."""
        model = self.model

        def wrap(fn, name, rounds=False):
            return wrap_step_callable(
                fn, name, self.config, tenant=self._tenant_label or None,
                rounds=self._live_rounds if rounds else None)
        stats = self.monitor is not None
        self._prefill = wrap(partial(model.prefill_slot, cap=self.cache_cap,
                                     collect_moe_stats=stats), "prefill")
        self._chunk_first = wrap(partial(
            model.prefill_chunk_slot, first=True, cap=self.cache_cap,
            collect_moe_stats=stats), "prefill_chunk")
        self._chunk = wrap(partial(
            model.prefill_chunk_slot, first=False, cap=self.cache_cap,
            collect_moe_stats=stats), "prefill_chunk")
        self._decode = wrap(model.decode_step_stats if stats
                            else model.decode_step, "decode_step",
                            rounds=True)
        if self._pool_size > 1:
            self._pool_step = wrap(self._make_pool_fn(stats), "pool_step",
                                   rounds=True)

    def _live_rounds(self):
        """The CURRENT permutation rounds (None off the "aurora" path), read
        through ``self.model`` at call time so telemetry follows mid-stream
        rounds swaps (``_rebind``)."""
        pc = self.model.pc
        return pc.aurora_rounds if pc is not None else None

    def _make_pool_fn(self, stats: bool):
        """One pooled engine step: the picked chunks, each a batch-1
        ``prefill_chunk_slot`` call (MoE capacity is per token group, so
        batching them would change the routing), then, when ``decode`` is
        set, the decode over every slot, all on the shared cache. Returns
        (per chunk (logits, counts), (logits, counts) of the decode or
        None, cache); counts are None without a monitor."""
        model = self.model
        chunk = partial(model.prefill_chunk_slot, cap=self.cache_cap,
                        collect_moe_stats=stats)
        dec = model.decode_step_stats if stats else model.decode_step

        def pool_fn(firsts, decode, params, toks, cache, slots, tokens,
                    mask):
            chunk_out = []
            for inp, slot, first in zip(toks, slots, firsts):
                out = chunk(params, inp, cache, slot, first=first)
                chunk_out.append((out[0], out[2] if stats else None))
            dec_out = None
            if decode:
                out = dec(params, tokens, cache, mask)
                dec_out = (out[0], out[2] if stats else None)
            return chunk_out, dec_out, cache

        return pool_fn

    def _rebind(self, model: Model) -> None:
        """Swap the model (a new replication layout) and rebuild the step
        callables. Serving state (cache, slots, queue, in-flight prefills)
        is untouched: placement-only as long as the new model computes the
        same function."""
        self.model = model
        self._build_steps()

    def _set_replication(self, spec) -> None:
        """Install a hot-expert ``ReplicationSpec`` (placement-only): the
        expert leaves move from the current layout to ``spec``'s, one
        (layer, weight kind) slab at a time, into the engine's own
        per-layer tensors (``relayout_moe_params``: the transient is one
        slab; the caller's leaves are only read). Routing, capacity and
        drops stay logical, so a mid-stream swap changes no token."""
        from ..models.moe import relayout_moe_params
        cur = self.model.replication
        if spec is not None and spec.is_identity:
            spec = None
        if spec is not None and self.model.cfg.moe is None:
            raise PlanError(f"{self.model.cfg.arch_id} has no experts to "
                            "replicate")
        if (None if cur is None else cur.counts) == \
                (None if spec is None else spec.counts):
            return
        self.params = relayout_moe_params(self.params, cur, spec,
                                          self.model.cfg.moe.n_experts)
        self._rebind(dataclasses.replace(self.model, replication=spec))
        record_adoption(self._telemetry, "replication",
                        step=self.decode_steps,
                        counts=None if spec is None else spec.counts)

    def adopt_replication(self, replication) -> None:
        """Adopt a planner host map (``Plan.replication``: per-expert host
        tuples) or a bare per-expert copy-count sequence. ``None`` or the
        identity map drops back to unreplicated serving. Idempotent: the
        same counts change nothing."""
        from ..models.moe import ReplicationSpec
        if replication is None:
            spec = None
        else:
            counts = tuple(
                len(h) if hasattr(h, "__len__") else int(h)
                for h in replication)
            spec = ReplicationSpec.from_counts(counts)
        self._set_replication(spec)

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
        if self.model.replication is not None:
            raise PlanError(
                "cannot re-seat an expert assignment while replicas are "
                "live — adopt_replication(None) first (the replicated "
                "leaves are in the widened physical frame)")
        new_pair = inverse_pair(e2d)              # device slot -> expert
        self.params = reseat_pairing(self.params,
                                     inverse_pair(self.assignment), new_pair,
                                     self.model.cfg)
        self.assignment = e2d
        if self.monitor is not None:
            self.monitor.slot_to_expert = new_pair
        record_adoption(self._telemetry, "assignment",
                        step=self.decode_steps, expert_to_device=e2d)

    def adopt(self, plan) -> None:
        """Adopt a placement mid-stream: an exclusive-scenario ``Plan`` (its
        ``expert_to_device`` assignment and/or its ``replication`` host
        map), a bare per-expert host-map or copy-count sequence, or None
        (drop back to unreplicated serving)."""
        if not hasattr(plan, "schedules"):
            self.adopt_replication(plan)
            return
        if (plan.pair is None and plan.groups is None
                and plan.replication is None and self.assignment is not None
                and len(plan.expert_to_device) == len(self.assignment)):
            self.adopt_assignment(plan.expert_to_device)
        self.adopt_replication(plan.replication)

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
                tel = self._telemetry
                if tel is not None and tel.enabled:
                    tel.count("serving_sheds_total",
                              help="submits rejected by shed-mode admission",
                              tenant=str(req.tenant), reason=reason)
                    tel.publish("shed", ev, step=self.decode_steps)
                return ev
        self.queue.append(req)
        return None

    def _bucket(self, n: int) -> int:
        if self.prefill_len is not None:
            if n > self.prefill_len:
                raise ValueError(f"prompt len {n} > prefill_len "
                                 f"{self.prefill_len}")
            return self.prefill_len
        p = self._bucketer(n)
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
        tel = self._telemetry
        if tel is not None and tel.enabled and r.max_new_tokens > 0:
            tel.count("serving_tokens_total",
                      help="tokens emitted", tenant=self._tenant_label)
            tel.observe("serving_ttft_steps",
                        max(0.0, self.decode_steps - r.arrival),
                        help="engine steps from arrival to first token "
                             "(step clock)",
                        bounds=STEP_BOUNDS, tenant=self._tenant_label)

    def _admit(self) -> None:
        """Drain the queue into free slots, one batch-1 prefill each, in the
        policy's queue order."""
        while self.queue and None in self.slots:
            slot = self.slots.index(None)
            r = self._pop_queue()
            padded = self._padded(r)
            out = self._prefill(
                self.params, {"tokens": torch.from_numpy(padded).to(
                    self.device)}, self.cache, slot)
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

    def _chunk_input(self, p: list, c: int) -> dict:
        """The next ``c`` padded prompt tokens of pending prefill ``p``, on
        the device."""
        toks, done = p[2], p[3]
        return {"tokens": torch.from_numpy(
            toks[:, done:done + c]).to(self.device)}

    def _advance_chunk(self, p: list, c: int, stats) -> None:
        """Book a chunk of ``c`` tokens that ran for pending prefill ``p``:
        under a monitor observe its routing counts ``stats``, then advance
        the prefill's offset."""
        r, _, toks, done = p
        if self.monitor is not None:
            # The chunk covers padded positions [done, done + c); the left
            # pad spans [0, total - len(prompt)) of the padded prompt.
            self._observe_prefill(stats,
                                  pad=toks.shape[1] - len(r.prompt) - done)
        p[3] = done + c
        self.prefills += 1

    def _run_chunk(self, p: list, c: int):
        """Run the next ``c`` tokens of pending prefill ``p`` into its slot
        row and book them. The first chunk starts the row from zero; later
        ones resume at its fill level. Returns the chunk's logits."""
        fn = self._chunk_first if p[3] == 0 else self._chunk
        out = fn(self.params, self._chunk_input(p, c), self.cache, p[1])
        self._advance_chunk(p, c, out[2] if self.monitor is not None
                            else None)
        return out[0]

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
        logits = self._run_chunk(p, c)
        if p[3] >= p[2].shape[1]:
            self._pending.pop(0)
            self._finish_admission(p[0], p[1], logits)
        return True

    def _pool_tick(self, fuse_decode: bool) -> bool:
        """Pooled chunked admission (``prefill_pool=K``): top the pool up in
        the policy's queue order, then run every picked chunk in the
        policy's run order and, when ``fuse_decode`` is set and slots are
        occupied, the decode over every slot (pending ones masked), as one
        pool step (``_make_pool_fn``).

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
        sel = [self._pending[i] for i in picked]
        sel_chunks = [chunks[i] for i in picked]
        toks = tuple(self._chunk_input(p, c) for p, c in zip(sel, sel_chunks))
        mask = np.array([r is not None for r in self.slots], bool)
        chunk_out, dec_out, self.cache = self._pool_step(
            tuple(p[3] == 0 for p in sel), decode, self.params, toks,
            self.cache, tuple(p[1] for p in sel), self.tokens,
            torch.from_numpy(mask).to(self.device))
        if decode:
            logits, stats = dec_out
            if self.monitor is not None:
                self._load_gauges(self._observe_decode_routing(stats, mask),
                                  mask)
            self.decode_steps += 1
            self._postdecode(logits)
        finished = []
        for p, c, (logits, stats) in zip(sel, sel_chunks, chunk_out):
            self._advance_chunk(p, c, stats)
            if p[3] >= p[2].shape[1]:
                finished.append((p, logits))
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
            logits, self.cache = self._decode(
                self.params, self.tokens, self.cache, row_mask)
            return logits
        logits, self.cache, stats = self._decode(
            self.params, self.tokens, self.cache, row_mask)
        self._load_gauges(self._observe_decode_routing(stats, mask), mask)
        return logits

    def _observe_decode_routing(self, stats, mask):
        """Fold one decode step's (L, B, E) routing counts into the monitor
        (host copy; ``mask`` (B,) bool marks the occupied rows). Returns
        the host counts."""
        arr = stats.cpu().numpy()
        self.monitor.observe(arr, mask)
        return arr

    def _load_gauges(self, arr, mask) -> None:
        """With a telemetry hub, the per-layer expert-load gauges of one
        decode step's host counts (the single-model engine's; the lockstep
        engines, whose tenants would share the gauges, set none, as in the
        reference)."""
        tel = self._telemetry
        if tel is None or not tel.enabled:
            return
        arr = np.asarray(arr, np.float64)            # (L, B, E)
        if mask is not None:
            arr = arr * np.asarray(mask, np.float64)[None, :, None]
        totals = arr.sum(axis=1)                     # (L, E)
        moe = self.model.cfg.moe
        cf = moe.capacity_factor if moe is not None else None
        for layer, row in enumerate(totals):
            tot = float(row.sum())
            if tot <= 0:
                continue
            tel.gauge("moe_expert_load_imbalance",
                      float(row.max()) * row.size / tot,
                      help="max/mean expert load this decode step "
                           "(1.0 = perfectly balanced)", layer=layer)
            if cf:
                cap = cf * tot / row.size
                tel.gauge("moe_expert_drop_rate",
                          float(np.maximum(row - cap, 0.0).sum()) / tot,
                          help="estimated fraction of routed tokens over "
                               "per-expert capacity (capacity_factor rule "
                               "applied to this step's counts)", layer=layer)

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
        emitted = 0
        for i, r in enumerate(self.slots):
            if r is None:
                continue
            r.out_tokens.append(int(host[i, 0]))
            emitted += 1
            if len(r.out_tokens) >= r.max_new_tokens:
                self.slots[i] = None
        tel = self._telemetry
        if tel is not None and tel.enabled and emitted:
            tel.count("serving_tokens_total", emitted,
                      help="tokens emitted", tenant=self._tenant_label)

    def step(self) -> bool:
        """Admit (whole prefills, or policy-admitted chunks), then decode
        all slots once. Returns False when idle. With a telemetry hub the
        step is an ``engine_step`` span and sets the queue-depth gauge."""
        tel = self._telemetry
        if tel is None or not tel.enabled:
            return self._step_impl()
        with tel.span("engine_step", step=self.decode_steps,
                      tenant=self._tenant_label or None):
            tel.gauge("serving_queue_depth", len(self.queue),
                      help="requests waiting for admission",
                      tenant=self._tenant_label)
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

    # -- fault tolerance ---------------------------------------------------
    def checkpoint(self) -> dict:
        """Snapshot of the serving state for step-level rollback after a
        corrupt step: a COPY of the cache and of the token buffer (both are
        written in place, so references would restore the mutated state;
        the copies stay on the cache's device), the slot map, the queue,
        the in-flight prefills and the emitted-token lengths. Request
        objects are shared with the live engine; ``restore`` rewinds their
        ``out_tokens``."""
        reqs = {id(r): r for r in self.slots if r is not None}
        for r in self.queue:
            reqs[id(r)] = r
        for p in self._pending:
            reqs[id(p[0])] = p[0]
        return {
            "cache": map_tree(torch.clone, self.cache),
            "tokens": self.tokens.clone(),
            "slots": list(self.slots),
            "queue": list(self.queue),
            "pending": [[p[0], p[1], p[2].copy(), p[3]]
                        for p in self._pending],
            "out_lens": [(r, len(r.out_tokens)) for r in reqs.values()],
            "decode_steps": self.decode_steps,
        }

    def restore(self, snap: dict) -> None:
        """Roll the engine back to a ``checkpoint`` snapshot: the cache is
        copied back into the live tensors (the snapshot stays usable);
        greedy decoding makes a re-run byte-identical."""
        with torch.no_grad():
            for live, saved in zip(tree_leaves(self.cache),
                                   tree_leaves(snap["cache"])):
                live.copy_(saved)
        self.tokens = snap["tokens"].clone()
        self.slots = list(snap["slots"])
        self.queue = collections.deque(snap["queue"])
        self._pending = [[p[0], p[1], p[2].copy(), p[3]]
                         for p in snap["pending"]]
        for r, ln in snap["out_lens"]:
            del r.out_tokens[ln:]
        self.decode_steps = snap["decode_steps"]

    def requeue(self, slots) -> list[Request]:
        """Fail-stop eviction: push the requests occupying ``slots`` (and
        any in-flight prefill reserving them) back onto the FRONT of the
        queue with their generation reset. Their cache rows count as lost:
        re-admission re-prefills from the prompt, and greedy decoding
        re-emits the same stream. Returns the evicted requests, in re-queue
        order."""
        lost = sorted({int(s) for s in slots})
        for s in lost:
            if not 0 <= s < self.batch_slots:
                raise FaultError(
                    f"cannot requeue slot {s}: out of "
                    f"range({self.batch_slots})")
        lost_set = set(lost)
        victims: list[Request] = []
        for p in list(self._pending):
            if p[1] in lost_set:
                self._pending.remove(p)
                victims.append(p[0])
        for s in lost:
            r = self.slots[s]
            if r is not None:
                self.slots[s] = None
                victims.append(r)
        for r in victims:
            r.out_tokens.clear()
        for r in reversed(victims):
            self.queue.appendleft(r)
        return victims

    def serve(self, reqs: list[Request]) -> list[Request]:
        """Run a request stream to completion, honoring ``arrival`` times
        (in engine steps; same-step arrivals are admitted in list order)."""
        serve_stream(self.step, [(self, reqs)])
        return reqs

