"""Bounded event storage (port of ``RingBuffer`` from
``repro/serving/events.py``).

``RingBuffer`` keeps the per-engine event list (``shed_events``) bounded:
list-like for its readers (iteration, ``len``, indexing, slicing), capped,
with a ``dropped`` counter so evicted history is visible rather than
silent. The reference's ``on_drop`` hook and its ``EventBus`` serve the
telemetry hub, which is not ported yet.
"""

from __future__ import annotations

import collections
from typing import Iterator


class RingBuffer:
    """Bounded drop-oldest buffer with list-like reads.

    Supports ``append``, ``extend``, ``clear``, ``len``, iteration, integer
    and slice indexing (slices return plain lists) and equality with a
    list, tuple, deque or another ``RingBuffer``. When full, ``append``
    evicts the oldest item and increments ``dropped``.
    """

    __slots__ = ("capacity", "dropped", "_buf")

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.dropped = 0
        self._buf: collections.deque = collections.deque(maxlen=self.capacity)

    def append(self, item) -> None:
        if len(self._buf) == self.capacity:
            self.dropped += 1
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
