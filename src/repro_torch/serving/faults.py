"""Deterministic fault injection and the closed recovery loop (port of
``repro/serving/faults.py``).

* ``FaultPlan``: a seedable, declarative script of faults (device loss at
  step t, expert-weight NaN corruption, straggler slowdown); frozen
  dataclasses, and ``FaultPlan.random`` gives the reference's plan for a
  seed (numpy's ``default_rng``).
* ``FaultInjector``: realises a plan against a live engine through the
  ``EngineConfig.step_wrapper`` seam. The wrapper times every step
  callable (after waiting for the card, so the time is the execution's)
  and feeds a ``HealthMonitor``; ``tick()``, once per ENGINE step, applies
  due faults: NaN written into the engine's own expert leaves, a lost
  device's heartbeat silenced, a straggler's reported step time inflated
  (synthetic: nothing sleeps).
* ``ChaosHarness``: tick, checkpoint, step, then react to the drained
  events. NaN: restore the pre-step checkpoint, repair the poisoned slots
  from a healthy replica (``repair_moe_params``) or, when none survives,
  from the pristine logical copy of the expert leaves taken at
  construction (held on the host), and re-run the step; greedy decoding
  makes the re-run byte-identical to a never-faulted run. Device loss:
  re-queue the lost device's slots and, given a planner and a trace,
  adopt a degraded plan: a distributed engine (one with
  ``adopt_degraded``) gets ``plan_degraded(ep_compatible=True)`` and
  rebuilds its EP group over the survivors; any other engine adopts
  ``plan_degraded(ep_compatible=False)``'s replication. Stragglers are
  recorded.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core.errors import FaultError
from ..models.moe import expert_leaves, expert_slabs, repair_moe_params
from .health import HealthMonitor
from .telemetry import block_until_ready

__all__ = ["DeviceLoss", "ExpertCorruption", "Straggler", "FaultPlan",
           "FaultInjector", "ChaosHarness", "corrupt_moe_params"]


# -- fault plan -------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DeviceLoss:
    """Fail-stop loss of ``device`` at engine step ``step``: its heartbeat
    goes silent (detection lags by the monitor's timeout — that lag is the
    bounded TTFT spike the chaos bench gates on)."""
    step: int
    device: int


@dataclasses.dataclass(frozen=True)
class ExpertCorruption:
    """Expert ``expert``'s weights turn NaN at step ``step`` (bit flip /
    bad shard). ``layer=None`` corrupts every layer's copy of the expert;
    an int corrupts one layer. Detection happens the first step the router
    sends a token through the poisoned slot."""
    step: int
    expert: int
    layer: int | None = None


@dataclasses.dataclass(frozen=True)
class Straggler:
    """Device ``device`` runs ``factor``x slow for ``duration`` steps
    starting at ``step`` (synthetic: the reported step-time signal is
    inflated; no real sleep)."""
    step: int
    device: int
    factor: float = 4.0
    duration: int = 32


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic script of faults, ordered by step."""
    faults: tuple = ()
    name: str = "chaos"

    def at(self, step: int) -> tuple:
        return tuple(f for f in self.faults if f.step == step)

    def horizon(self) -> int:
        """Last step at which any fault is active."""
        h = 0
        for f in self.faults:
            end = f.step + (f.duration if isinstance(f, Straggler) else 0)
            h = max(h, end)
        return h

    @property
    def has_corruption(self) -> bool:
        return any(isinstance(f, ExpertCorruption) for f in self.faults)

    @classmethod
    def random(cls, seed: int, horizon: int, n_devices: int, n_experts: int,
               n_faults: int = 2, kinds: tuple = ("device_loss",
                                                  "corruption",
                                                  "straggler"),
               max_losses: int | None = None) -> "FaultPlan":
        """Deterministic random plan for chaos property tests. At most
        ``max_losses`` (default: n_devices - 1) distinct devices die, so a
        survivor always exists for ``plan_degraded``."""
        rng = np.random.default_rng(seed)
        if max_losses is None:
            max_losses = n_devices - 1
        faults, lost = [], set()
        for _ in range(n_faults):
            kind = kinds[int(rng.integers(len(kinds)))]
            step = int(rng.integers(1, max(horizon, 2)))
            if kind == "device_loss":
                alive = [d for d in range(n_devices) if d not in lost]
                if len(lost) >= max_losses or not alive:
                    kind = "straggler"
                else:
                    d = alive[int(rng.integers(len(alive)))]
                    lost.add(d)
                    faults.append(DeviceLoss(step=step, device=d))
                    continue
            if kind == "corruption":
                faults.append(ExpertCorruption(
                    step=step, expert=int(rng.integers(n_experts))))
            else:
                faults.append(Straggler(
                    step=step, device=int(rng.integers(n_devices)),
                    factor=float(2.0 + 4.0 * rng.random()),
                    duration=int(rng.integers(8, 33))))
        return cls(faults=tuple(sorted(faults, key=lambda f: f.step)),
                   name=f"random-{seed}")


# -- weight corruption ------------------------------------------------------
def corrupt_moe_params(params, phys_slot: int, layer: int | None = None,
                       axis: int = 1):
    """Poison one physical expert slot of every float expert leaf with NaN,
    IN PLACE (the engine's own leaves; the fault ``repair_moe_params``
    undoes); returns ``params``. ``layer=None`` poisons every layer's copy.
    ``axis`` is the expert axis of stacked leaves (1 for full-model
    (layer, E, ...) segments, 0 for a standalone layer dict)."""
    with torch.no_grad():
        for leaf in expert_leaves(params):
            slabs = expert_slabs(leaf, axis)
            if not slabs[0].is_floating_point():
                continue
            if layer is not None and axis > 0:
                slabs = [slabs[layer]]
            for t in slabs:
                t[phys_slot] = float("nan")
    return params


# -- injector ---------------------------------------------------------------
class FaultInjector:
    """Realize a ``FaultPlan`` against a live engine.

    Construction order matters: the injector exists FIRST (its ``wrap`` is
    the ``EngineConfig.step_wrapper``), the engine is built with that
    config, then ``attach(engine)`` closes the loop. ``tick()`` must be
    called once per engine step, before ``engine.step()`` — the chaos
    harness does this; a custom serving loop can too.
    """

    def __init__(self, plan: FaultPlan, n_devices: int,
                 health: HealthMonitor | None = None):
        self.plan = plan
        self.n_devices = int(n_devices)
        self.health = health or HealthMonitor(n_devices=self.n_devices)
        self.engine = None
        self.step = 0                    # engine steps ticked so far
        self.lost: set[int] = set()
        self.corrupted_phys: set[int] = set()
        self._stragglers: dict[int, tuple[float, int]] = {}  # d -> (f, end)
        self._applied: set[int] = set()

    def attach(self, engine) -> None:
        self.engine = engine

    # The step_wrapper seam: time every step callable, feed the monitor's
    # EWMAs (straggler-inflated for the afflicted device; synthetic, no
    # sleep) and NaN guard. Every step callable of every engine flows
    # through this one seam.
    def wrap(self, fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            out = block_until_ready(out)
            dt = time.perf_counter() - t0
            step = max(self.step - 1, 0)
            for d in range(self.n_devices):
                if d in self.lost:
                    continue
                f = self._stragglers.get(d)
                self.health.observe_step_time(
                    d, dt * f[0] if f is not None else dt)
            self.health.observe_output(out, step)
            return out
        return wrapped

    def tick(self) -> None:
        """Advance the fault clock one ENGINE step: apply newly due faults,
        expire finished stragglers, heartbeat the alive devices."""
        now = self.step
        for i, f in enumerate(self.plan.faults):
            if i in self._applied or f.step > now:
                continue
            self._applied.add(i)
            self._apply(f)
        for d, (factor, end) in list(self._stragglers.items()):
            if now >= end:
                del self._stragglers[d]
        for d in range(self.n_devices):
            if d not in self.lost:
                self.health.heartbeat(d, now)
        self.step = now + 1

    def _apply(self, f) -> None:
        tel = getattr(self.health, "telemetry", None)
        if tel is not None and tel.enabled:
            tel.count("serving_faults_injected_total",
                      help="faults injected by the chaos plan",
                      kind=type(f).__name__)
            tel.publish("fault_injected", f, step=self.step)
        if isinstance(f, DeviceLoss):
            self.lost.add(int(f.device))
        elif isinstance(f, Straggler):
            self._stragglers[int(f.device)] = (
                float(f.factor), f.step + int(f.duration))
        elif isinstance(f, ExpertCorruption):
            if self.engine is None:
                raise FaultError(
                    "ExpertCorruption needs an attached engine — call "
                    "FaultInjector.attach(engine) before serving")
            spec = self.engine.model.replication
            e = int(f.expert)
            phys = spec.base[e] if spec is not None else e
            self.engine.params = corrupt_moe_params(
                self.engine.params, phys, layer=f.layer)
            self.corrupted_phys.add(phys)
        else:
            raise FaultError(f"unknown fault type {type(f).__name__}")

    def clear_corrupted(self) -> None:
        self.corrupted_phys.clear()


# -- recovery loop ----------------------------------------------------------
class ChaosHarness:
    """Closed detect-and-recover loop around one continuous engine.

    Per step: ``injector.tick()`` (faults land), checkpoint when the plan
    can corrupt weights, ``engine.step()``, ``health.check()``, then react
    to the drained events:

    * ``nan``: restore the pre-step checkpoint, repair the poisoned slots
      in place from a healthy replica (``repair_moe_params``) or, when no
      replica survives, from the pristine copy, and re-run the step.
    * ``device_loss``: fail-stop: re-queue the slots resident on the lost
      device (``slots_of_device``; default round-robin ``slot % n``) and,
      given a planner and a trace, re-plan: an engine with
      ``adopt_degraded`` (``DistributedEngine``) gets
      ``plan_degraded(failed_devices=..., ep_compatible=True)`` and
      rebuilds its EP group over the survivors; any other engine adopts
      ``plan_degraded(..., ep_compatible=False)``'s replication (one
      card: a device is a group of slots, the experts stay on the card).
      The planner's devices that a lost device stood for are
      ``hosts_of_device(d)`` (default: the engine's
      ``planner_devices(d)``, a rank's block of expert slots, where it
      has one, else ``[d]``, the reference's one-to-one frame); give it
      when the injector's devices are fewer than the planner's.
    * ``straggler``: recorded in ``recoveries`` (re-planning around slow
      devices is the traffic monitor's drift loop, not a failover).

    The pristine copy holds only the expert leaves (nothing else can be
    corrupted), in the logical frame, on the host; ``pristine_bytes``
    says how large it is.
    """

    def __init__(self, engine, injector: FaultInjector, planner=None,
                 trace=None, slots_of_device=None, hosts_of_device=None):
        injector.attach(engine)
        self.engine = engine
        self.injector = injector
        self.health = injector.health
        self.planner = planner
        self.trace = trace
        self._slots_of_device = slots_of_device or (
            lambda d: [s for s in range(engine.batch_slots)
                       if s % injector.n_devices == d])
        self._hosts_of_device = (hosts_of_device
                                 or getattr(engine, "planner_devices", None)
                                 or (lambda d: [d]))
        self.recoveries: list[dict] = []
        self._handled_loss: set[int] = set()
        spec = engine.model.replication
        home = torch.as_tensor(
            spec.base if spec is not None
            else range(engine.model.cfg.moe.n_experts), dtype=torch.long)
        # One logical slab at a time (a copy, never a view of the live
        # weights, which corruption writes in place), then to the host.
        self._pristine = [
            [t.index_select(0, home.to(t.device)).cpu()
             for t in expert_slabs(leaf)]
            for leaf in expert_leaves(engine.params)]
        self.pristine_bytes = sum(t.numel() * t.element_size()
                                  for leaf in self._pristine for t in leaf)

    def step(self) -> bool:
        inj, eng = self.injector, self.engine
        inj.tick()
        now = inj.step - 1
        snap = eng.checkpoint() if inj.plan.has_corruption else None
        worked = eng.step()
        self.health.check(now)
        for ev in self.health.drain():
            if ev.kind == "nan":
                worked = self._recover_nan(ev, snap) or worked
            elif ev.kind == "device_loss":
                self._recover_loss(ev)
            else:
                self._record_recovery(
                    {"event": ev, "action": "observed"})
        return worked

    def _record_recovery(self, entry: dict) -> None:
        self.recoveries.append(entry)
        tel = getattr(self.health, "telemetry", None)
        if tel is not None and tel.enabled:
            tel.count("serving_recoveries_total",
                      help="recovery actions taken by the chaos harness",
                      action=entry["action"])
            tel.publish("recovery", entry,
                        step=max(self.injector.step - 1, 0))

    def serve(self, reqs) -> list:
        from .engine import serve_stream
        serve_stream(self.step, [(self.engine, reqs)])
        return reqs

    # -- reactions ---------------------------------------------------------
    def _recover_nan(self, ev, snap) -> bool:
        eng, inj = self.engine, self.injector
        if snap is None:
            raise FaultError(
                "NaN detected but no pre-step checkpoint exists — the "
                "fault plan declared no corruption faults, so this is a "
                "genuine numeric failure, not an injected one")
        eng.restore(snap)
        bad = sorted(inj.corrupted_phys)
        spec = eng.model.replication
        try:
            repair_moe_params(eng.params, spec, bad)
            action = "repaired-from-replica"
        except FaultError:
            # No healthy replica: copy the poisoned slots back from the
            # pristine logical copy (byte-identical by definition); no
            # other slot was written.
            p2l = (spec.phys_to_logical if spec is not None
                   else range(eng.model.cfg.moe.n_experts))
            with torch.no_grad():
                for leaf, pristine in zip(expert_leaves(eng.params),
                                          self._pristine):
                    for t, home in zip(expert_slabs(leaf), pristine):
                        for p in bad:
                            t[p].copy_(home[p2l[p]])
            action = "restored-pristine"
        inj.clear_corrupted()
        self._record_recovery({"event": ev, "action": action,
                               "bad_phys": bad})
        return eng.step()                 # re-run the rolled-back step

    def _recover_loss(self, ev) -> None:
        eng = self.engine
        d = int(ev.device)
        if d in self._handled_loss:
            return
        self._handled_loss.add(d)
        victims = eng.requeue(self._slots_of_device(d))
        entry = {"event": ev, "action": "requeued",
                 "requeued": len(victims)}
        if self.planner is not None and self.trace is not None:
            failed = sorted({h for lost in self._handled_loss
                             for h in self._hosts_of_device(lost)})
            # A distributed engine rebuilds its EP group over the
            # survivors: their count must divide the expert count, so the
            # planner is asked for an EP-compatible degraded plan.
            distributed = hasattr(eng, "adopt_degraded")
            plan = self.planner.plan_degraded(
                self.trace, failed_devices=failed,
                ep_compatible=distributed)
            if distributed:
                eng.adopt_degraded(plan)
            else:
                eng.adopt(plan.replication)
            entry["action"] = "requeued+replanned"
            entry["survivors"] = plan.survivors
        self._record_recovery(entry)

