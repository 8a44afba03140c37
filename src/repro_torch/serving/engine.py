"""Continuous-batching engine (port of ``ContinuousEngine`` and its helpers
from ``repro/serving/engine.py``, one-shot admission only).

``ContinuousEngine`` owns a request queue plus ``batch_slots`` decode slots
over a shared per-slot KV cache (``init_cache(per_slot_len=True)``). Each
step admits queued requests into free slots (a batch-1 prefill copied into
the slot's cache row, ``Model.prefill_slot``), then decodes every slot once
and evicts finished requests.

The reference's semantics are kept exactly, because greedy token streams
are compared with it: prompts are left-padded with 0 to their bucket (pad
tokens are not masked); vacant slots decode too, so their stale tokens take
part in MoE routing and capacity at T = batch_slots (their cache rows and
lengths stay frozen); and the current-token buffer is replaced wholesale by
the argmax over all rows after each decode.

The cache is updated in place (the reference donates it to a jitted step).
Chunked prefill, the prefill pool, the monitor/replanner, replication,
telemetry and fault tolerance are not ported yet.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..models import Model
from .config import EngineConfig

__all__ = ["Request", "poisson_requests", "serve_stream", "ContinuousEngine"]


@dataclasses.dataclass
class Request:
    prompt: Sequence[int]
    max_new_tokens: int = 16
    arrival: float = 0.0                 # engine-step time of arrival
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
    over idle gaps when nothing is active but requests are still due."""
    streams = [[eng, sorted(reqs, key=lambda r: r.arrival), 0]
               for eng, reqs in pools]
    t = 0.0
    while any(i < len(p) or e.queue or e.num_active
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

    The slot state machine lives on the host (``queue`` + ``slots``); the
    device holds the shared cache and the (B, 1) current-token buffer.
    """

    def __init__(self, model: Model, params, batch_slots: int,
                 cache_cap: int, config: EngineConfig | None = None):
        config = config if config is not None else EngineConfig()
        self.config = config
        model = config.kernelize(model)
        self.model = model
        self.params = params
        self.device = model.device
        self.batch_slots = batch_slots
        self.cache_cap = cache_cap
        self.admission = config.resolve_admission()
        self.prefill_len = config.prefill_len
        self.cache = model.init_cache(batch_slots, cache_cap,
                                      per_slot_len=True)
        self.tokens = torch.zeros((batch_slots, 1), dtype=torch.long,
                                  device=self.device)
        self.queue: collections.deque[Request] = collections.deque()
        self.slots: list[Request | None] = [None] * batch_slots
        self.decode_steps = 0
        self.prefills = 0

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self.slots)

    def submit(self, req: Request) -> None:
        # The final per-slot length is pad(prompt) + max_new_tokens - 1
        # (the last emitted token is never written back).
        p = self._bucket(len(req.prompt))
        need = p + max(req.max_new_tokens - 1, 0)
        if need > self.cache_cap:
            raise ValueError(
                f"prompt + generation needs {need} cache slots, "
                f"capacity is {self.cache_cap}")
        self.queue.append(req)

    def _bucket(self, n: int) -> int:
        if self.prefill_len is not None:
            if n > self.prefill_len:
                raise ValueError(f"prompt len {n} > prefill_len "
                                 f"{self.prefill_len}")
            return self.prefill_len
        p = self.admission.pad(n)
        if p < n:
            raise ValueError(f"bucket policy shrank {n} to {p}")
        return min(p, self.cache_cap)

    def _finish_admission(self, r: Request, slot: int, logits) -> None:
        """Emit the first token and occupy the slot (unless already done)."""
        tok0 = int(torch.argmax(logits[0, -1, : self.model.cfg.vocab]))
        if r.max_new_tokens > 0:
            r.out_tokens.append(tok0)
        if len(r.out_tokens) < r.max_new_tokens:
            self.slots[slot] = r
            self.tokens[slot, 0] = tok0

    def _admit(self) -> None:
        """Drain the queue into free slots, one batch-1 prefill each."""
        while self.queue and None in self.slots:
            slot = self.slots.index(None)
            r = self.queue.popleft()
            p = self._bucket(len(r.prompt))
            toks = np.zeros((1, p), np.int64)
            toks[0, p - len(r.prompt):] = r.prompt      # left-pad with 0
            logits, self.cache = self.model.prefill_slot(
                self.params, {"tokens": torch.from_numpy(toks).to(self.device)},
                self.cache, slot, cap=self.cache_cap)
            self.prefills += 1
            self._finish_admission(r, slot, logits)

    def _decode_all(self):
        """One fixed-shape decode over every slot; vacant rows keep their
        cache state and fill level (``row_mask``)."""
        mask = torch.tensor([r is not None for r in self.slots],
                            device=self.device)
        logits, self.cache = self.model.decode_step(
            self.params, self.tokens, self.cache, mask)
        return logits

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
        """Admit whole prefills, then decode all slots once. Returns False
        when idle."""
        self._admit()
        if self.num_active == 0:
            return False
        logits = self._decode_all()
        self.decode_steps += 1
        self._postdecode(logits)
        return True

    def serve(self, reqs: list[Request]) -> list[Request]:
        """Run a request stream to completion, honoring ``arrival`` times
        (in engine steps; same-step arrivals are admitted in list order)."""
        serve_stream(self.step, [(self, reqs)])
        return reqs
