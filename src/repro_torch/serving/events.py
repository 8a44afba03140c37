"""Bounded event storage and the unified typed event bus (port of
``repro/serving/events.py``).

``RingBuffer`` keeps the per-engine event lists (``shed_events``,
``HealthMonitor.events``) bounded: list-like for their readers (iteration,
``len``, indexing, slicing), capped, with a ``dropped`` counter so evicted
history is visible rather than silent.

``EventBus`` is the one stream that ``ShedEvent``, ``ReplanEvent``,
``FaultEvent`` and adoption and recovery notices publish into. Every
publish gets a monotonic ``seq`` and a timestamp, so re-plan and recovery
timelines interleave deterministically with spans in one exported trace.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Iterator


class RingBuffer:
    """Bounded drop-oldest buffer with list-like reads.

    Supports ``append``, ``extend``, ``clear``, ``len``, iteration, integer
    and slice indexing (slices return plain lists) and equality with a
    list, tuple, deque or another ``RingBuffer``. When full, ``append``
    evicts the oldest item, increments ``dropped`` and calls
    ``on_drop(item)`` if given (the telemetry hub counts evictions so).
    """

    __slots__ = ("capacity", "dropped", "_buf", "_on_drop")

    def __init__(self, capacity: int = 4096,
                 on_drop: Callable[[Any], None] | None = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.dropped = 0
        self._buf: collections.deque = collections.deque(maxlen=self.capacity)
        self._on_drop = on_drop

    def append(self, item) -> None:
        if len(self._buf) == self.capacity:
            self.dropped += 1
            if self._on_drop is not None:
                self._on_drop(self._buf[0])
        self._buf.append(item)

    def extend(self, items) -> None:
        for it in items:
            self.append(it)

    def clear(self) -> None:
        self._buf.clear()

    def __len__(self) -> int:
        return len(self._buf)

    def __bool__(self) -> bool:
        return bool(self._buf)

    def __iter__(self) -> Iterator:
        return iter(self._buf)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return list(self._buf)[idx]
        return self._buf[idx]

    def __eq__(self, other) -> bool:
        if isinstance(other, (list, tuple, RingBuffer, collections.deque)):
            return list(self._buf) == list(other)
        return NotImplemented

    def __repr__(self) -> str:
        return (f"RingBuffer(capacity={self.capacity}, len={len(self._buf)}, "
                f"dropped={self.dropped})")


@dataclasses.dataclass(frozen=True)
class BusEvent:
    """One published event: a typed payload plus ordering metadata. ``seq``
    is the bus's monotonic counter (the deterministic order); ``ts`` is the
    publish time, used only to interleave events with spans in exports."""

    seq: int
    kind: str
    ts: float
    step: int | None
    payload: Any


class EventBus:
    """Unified bounded stream of typed serving events.

    ``publish(kind, payload, step=)`` wraps the payload in a ``BusEvent``
    with the next ``seq`` and appends it to a bounded ring. ``counts``
    keeps per-kind totals that survive eviction; ``subscribe`` registers a
    callback called synchronously, in publish order, for every event.
    """

    def __init__(self, capacity: int = 4096,
                 clock: Callable[[], float] = time.time,
                 on_drop: Callable[[Any], None] | None = None):
        self._ring = RingBuffer(capacity, on_drop=on_drop)
        self._seq = 0
        self._clock = clock
        self.counts: collections.Counter = collections.Counter()
        self._subscribers: list[Callable[[BusEvent], None]] = []

    def subscribe(self, fn: Callable[[BusEvent], None]) -> None:
        self._subscribers.append(fn)

    def publish(self, kind: str, payload, step: int | None = None) -> BusEvent:
        ev = BusEvent(seq=self._seq, kind=str(kind), ts=self._clock(),
                      step=None if step is None else int(step),
                      payload=payload)
        self._seq += 1
        self.counts[ev.kind] += 1
        self._ring.append(ev)
        for fn in self._subscribers:
            fn(ev)
        return ev

    def events(self, kind: str | None = None) -> list[BusEvent]:
        if kind is None:
            return list(self._ring)
        return [e for e in self._ring if e.kind == kind]

    @property
    def dropped(self) -> int:
        return self._ring.dropped

    def __len__(self) -> int:
        return len(self._ring)

    def __iter__(self) -> Iterator[BusEvent]:
        return iter(self._ring)
