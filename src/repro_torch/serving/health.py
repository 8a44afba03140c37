"""HealthMonitor: failure detection from live serving signals (port of
``repro/serving/health.py``).

Sits beside ``TrafficMonitor`` (which watches WHERE tokens route; this
watches WHETHER the cluster is healthy) and turns three live signals into
typed ``FaultEvent``s:

* NaN/inf guard: every wrapped step's outputs (logits, cache writes) are
  screened for non-finite values ON THE DEVICE (one ``isfinite``
  reduction per floating tensor, one host read per step; the cache is
  never copied to the host). Corrupt expert weights surface the first
  step the router sends a kept token through them.
* Stragglers: per-device step-time EWMAs; a warmed-up device whose EWMA
  exceeds ``straggler_ratio`` x the median of its peers is flagged.
* Missing heartbeats: a device silent for ``heartbeat_timeout`` engine
  steps is declared lost (fail-stop), the trigger for degraded
  re-planning.

Detection only: the monitor never mutates the engine. The recovery loop
(``serving.faults.ChaosHarness``) drains ``events`` and decides.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .events import RingBuffer
from .telemetry import tree_leaves


__all__ = ["FaultEvent", "HealthMonitor"]


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One detected failure. ``kind`` is "nan", "straggler" or
    "device_loss"; ``step`` is the engine step of DETECTION (injection may
    be earlier — a corrupt expert is invisible until routed to); ``device``
    is the suspect device (None for model-wide signals like NaN outputs)."""

    kind: str
    step: int
    device: int | None = None
    detail: str = ""


class HealthMonitor:
    """Streaming failure detector over ``n_devices`` devices.

    ``observe_step_time(device, dt)`` feeds the straggler EWMAs (halflife
    in steps); ``observe_output(out, step)`` screens a pytree of step
    outputs for non-finite values; ``heartbeat(device, step)`` marks
    liveness; ``check(step)`` sweeps the heartbeat table and EWMAs and
    appends any NEW events (each device is reported lost once, flagged
    straggler once per episode). ``drain()`` hands the accumulated events
    to the recovery loop and clears the queue; ``events`` keeps recent
    history for audits — a bounded drop-oldest ring (``capacity``), so a
    long-running monitor cannot grow without limit; evictions are counted
    on the ring's ``dropped``.

    The first ``min_observations`` step-time samples are averaged with
    EQUAL weight (no decay) before the EWMA takes over: decay-folding
    from zero would make a slow cold-start step dominate the baseline for
    ~a halflife and mis-arm straggler detection. ``armed(device)`` (and
    the ``device_detector_armed`` gauge when ``telemetry`` is attached)
    exposes the warming/armed state.

    ``telemetry`` (optional ``serving.Telemetry``) receives every
    FaultEvent on the unified bus plus per-device step-time/armed gauges.
    """

    def __init__(self, n_devices: int = 1, halflife: float = 16.0,
                 straggler_ratio: float = 3.0, heartbeat_timeout: int = 8,
                 min_observations: int = 4, capacity: int = 4096,
                 telemetry=None):
        if n_devices < 1:
            raise ValueError("HealthMonitor.n_devices must be >= 1")
        if halflife <= 0:
            raise ValueError("HealthMonitor.halflife must be > 0 steps")
        if straggler_ratio <= 1:
            raise ValueError("HealthMonitor.straggler_ratio must be > 1 "
                             "(1.0 would flag every device)")
        if heartbeat_timeout < 1:
            raise ValueError("HealthMonitor.heartbeat_timeout must be >= 1")
        self.n_devices = int(n_devices)
        self.halflife = float(halflife)
        self.straggler_ratio = float(straggler_ratio)
        self.heartbeat_timeout = int(heartbeat_timeout)
        self.min_observations = int(min_observations)
        self._decay = 0.5 ** (1.0 / self.halflife)
        self._ewma_num = np.zeros(self.n_devices)
        self._ewma_den = np.zeros(self.n_devices)
        self._n_obs = np.zeros(self.n_devices, dtype=int)
        self._last_beat: dict[int, int] = {}
        self._lost: set[int] = set()
        self._straggling: set[int] = set()
        self._nan_steps: set[int] = set()
        self.events: RingBuffer = RingBuffer(capacity)
        self._pending: RingBuffer = RingBuffer(capacity)
        self.telemetry = telemetry

    # -- signal feeds ------------------------------------------------------
    def heartbeat(self, device: int, step: int) -> None:
        self._last_beat[int(device)] = int(step)

    def observe_step_time(self, device: int, dt: float) -> None:
        d = int(device)
        if self._n_obs[d] < self.min_observations:
            # Warm-up: equal-weight mean. Decay-folding from zero would
            # weight the very first sample by a full decay factor over
            # each later one, so one slow cold step (compile, cache fill)
            # would bias the straggler baseline long after warm-up.
            self._ewma_num[d] += float(dt)
            self._ewma_den[d] += 1.0
        else:
            self._ewma_num[d] = self._ewma_num[d] * self._decay + float(dt)
            self._ewma_den[d] = self._ewma_den[d] * self._decay + 1.0
        self._n_obs[d] += 1
        tel = self.telemetry
        if tel is not None and tel.enabled:
            tel.gauge("device_step_seconds",
                      float(self._ewma_num[d]
                            / max(self._ewma_den[d], 1e-12)),
                      help="per-device EWMA step time (seconds)", device=d)
            tel.gauge("device_detector_armed", float(self.armed(d)),
                      help="1 once the straggler detector has warmed up "
                           "(min_observations samples)", device=d)

    def armed(self, device: int) -> bool:
        """True once ``device`` has enough samples for straggler checks."""
        return bool(self._n_obs[int(device)] >= self.min_observations)

    @property
    def warming_devices(self) -> tuple[int, ...]:
        """Devices still inside the equal-weight warm-up window."""
        return tuple(int(d) for d in range(self.n_devices)
                     if self._n_obs[d] < self.min_observations)

    def observe_output(self, out, step: int) -> bool:
        """Screen a tree of step outputs for NaN/inf: every floating tensor
        is reduced where it lives, and the flags are read back once.
        Returns True when clean; records (at most one per step) a "nan"
        event when not."""
        flags = [torch.isfinite(t).all() for t in tree_leaves(out)
                 if torch.is_tensor(t) and t.is_floating_point()]
        clean = not flags or bool(torch.stack(flags).all())
        if not clean and step not in self._nan_steps:
            self._nan_steps.add(step)
            self._emit(FaultEvent(
                kind="nan", step=int(step),
                detail="non-finite values in step outputs — corrupt "
                       "weights or numeric overflow"))
        return clean

    # -- detection sweep ---------------------------------------------------
    def step_times(self) -> np.ndarray:
        """Per-device EWMA step times (NaN where unobserved)."""
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(self._ewma_den > 0,
                            self._ewma_num / np.maximum(self._ewma_den,
                                                        1e-12),
                            math.nan)

    def check(self, step: int) -> list[FaultEvent]:
        """Sweep heartbeats and EWMAs at engine step ``step``; emit NEW
        events. A device with no heartbeat for ``heartbeat_timeout`` steps
        is lost (once); a warmed-up device whose EWMA exceeds
        ``straggler_ratio`` x the median of the others straggles (once per
        episode — recovery below the threshold re-arms the flag)."""
        new: list[FaultEvent] = []
        for d, last in sorted(self._last_beat.items()):
            if d in self._lost:
                continue
            if step - last >= self.heartbeat_timeout:
                self._lost.add(d)
                ev = FaultEvent(
                    kind="device_loss", step=int(step), device=d,
                    detail=f"no heartbeat for {step - last} steps "
                           f"(timeout {self.heartbeat_timeout})")
                self._emit(ev)
                new.append(ev)
        times = self.step_times()
        for d in range(self.n_devices):
            if d in self._lost or self._n_obs[d] < self.min_observations:
                continue
            peers = [times[o] for o in range(self.n_devices)
                     if o != d and not math.isnan(times[o])]
            if not peers:
                continue
            med = float(np.median(peers))
            if med > 0 and times[d] > self.straggler_ratio * med:
                if d not in self._straggling:
                    self._straggling.add(d)
                    ev = FaultEvent(
                        kind="straggler", step=int(step), device=d,
                        detail=f"EWMA step time {times[d]:.3g} > "
                               f"{self.straggler_ratio:g}x peer median "
                               f"{med:.3g}")
                    self._emit(ev)
                    new.append(ev)
            else:
                self._straggling.discard(d)
        return new

    @property
    def lost_devices(self) -> tuple[int, ...]:
        return tuple(sorted(self._lost))

    def _emit(self, ev: FaultEvent) -> None:
        self.events.append(ev)
        self._pending.append(ev)
        tel = self.telemetry
        if tel is not None and tel.enabled:
            tel.count("serving_faults_total",
                      help="detected faults by kind", kind=ev.kind)
            tel.publish("fault", ev, step=ev.step)

    def drain(self) -> list[FaultEvent]:
        """Events since the last drain (the recovery loop's work queue)."""
        out = list(self._pending)
        self._pending.clear()
        return out
