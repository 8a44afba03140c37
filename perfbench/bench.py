"""One run of one cell: set-up, the measured window, the comparison, the
metrics.

A cell of ``BENCHMARK.json`` names a configuration (its ``file``) and a
traffic mix (``traffic/<name>.json``); each metric is read by
``metrics/<name>.py``. Nothing here names a cell, a configuration or a
metric, so a later cell is added as files and entries alone.

Set-up builds the program's ``ContinuousEngine`` over the configuration
(its ``port`` section), fills the benchmark's seeded weights on the
device, and warms every prompt bucket the mix can send and the full-slot
decode. The window then drives the engine through its public ``submit``
and ``step``: an open loop submits each request once its wall-clock due
time has passed and times it from that due time; a closed loop's callers
each submit their next request as soon as the last has all its tokens.
Each request's token list stamps the host clock as a token is appended,
which the engine does right after it has read the token back from the
device. After the window an open loop keeps the load on until every
request due in it is served (``drain_s`` at most); the rest count as
failed.

A traced run (``trace=True``) attaches the program's telemetry hub
(``serving.Telemetry``: a span around every step callable, with a
``record_function`` range of its name), records every ``moe_gmm`` and
``decode_attn`` call's logical inputs through wrappers of the program's
``kernels.ops`` entry points, and profiles a slice of the window with
``torch.profiler``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import torch

from . import check, readers, trace as trace_mod
from .roofline import ModelFlops, decode_attn_cost, moe_gmm_cost
from .traffic import Callers, buckets, length_range, open_loop

ROOT = Path(__file__).resolve().parents[1]
RANGES = {"moe_gmm": "perfbench.moe_gmm",
          "decode_attn": "perfbench.decode_attn"}


# ---------------------------------------------------------------------------
# The cell, found by name

@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration file
    mix: dict               # the traffic file
    end_to_end: list        # metric entries this cell reports
    per_layer: list


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    w = {c["name"]: c for c in spec["workloads"]}.get(workload)
    if w is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "perfbench" / "traffic"
                      / f"{w['traffic']}.json").read_text())
    return Cell(workload, int(w["chips"]), config, mix,
                [m for m in spec["end_to_end"] if _reports(m, workload)],
                [m for m in spec["per_layer"] if _reports(m, workload)])


def reader(name: str, root: Path = ROOT):
    """``metrics/<name>.py``'s ``read``; a name with a suffix after its
    first dot (``decode_step_ms.sat``: the same quantity, split by the
    end-to-end metric it moves) falls back to the reader of the name
    before the dot."""
    metrics = root / "perfbench" / "metrics"
    path = metrics / f"{name}.py"
    if not path.exists():
        path = metrics / f"{name.split('.')[0]}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def model_config(config: dict):
    """The program's ``ModelConfig`` from the file's ``port`` section."""
    from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig
    port = dict(config["port"])
    moe, mla = port.pop("moe", None), port.pop("mla", None)
    return ModelConfig(source=config["source"],
                       moe=MoEConfig(**moe) if moe else None,
                       mla=MLAConfig(**mla) if mla else None, **port)


# ---------------------------------------------------------------------------
# Requests as the harness sees them

class TimedTokens(list):
    """A request's token list that stamps the host clock at each append."""

    def __init__(self):
        super().__init__()
        self.times: list[float] = []

    def append(self, tok) -> None:
        self.times.append(time.perf_counter())
        super().append(tok)


@dataclasses.dataclass
class Record:
    prompt: np.ndarray
    req: object             # the program's Request
    due: float              # host clock (perf_counter) it was due at
    in_window: bool
    submitted: float = 0.0  # host clock of the submit

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def tokens(self) -> list:
        return list(self.req.out_tokens)

    @property
    def times(self) -> list:
        return self.req.out_tokens.times

    @property
    def done(self) -> bool:
        return len(self.req.out_tokens) >= self.req.max_new_tokens


@dataclasses.dataclass
class Run:
    """What a metric reader reads. Times are host-clock seconds
    (``time.perf_counter``); the window is [t0, t0 + seconds)."""

    seconds: float
    setup_s: float
    t0: float
    records: list
    steps: list             # (start, end, queue length after the step)
    spans: list             # (name, start, duration) of the hub's spans
    kernel_calls: dict      # kernel -> [(flops, bytes)] in the profiled slice
    profile: dict | None    # trace.summarize of the profiled slice
    flops: ModelFlops
    cap: int

    @property
    def window(self) -> list:
        return [r for r in self.records if r.in_window]


def _submit(engine, send, seed, vocab, due, in_window):
    from repro_torch.serving import Request
    prompt = send.tokens(seed, vocab)
    req = Request(prompt=prompt, max_new_tokens=send.max_new,
                  arrival=float(engine.decode_steps))
    req.out_tokens = TimedTokens()
    engine.submit(req)
    return Record(prompt, req, due, in_window, time.perf_counter())


# ---------------------------------------------------------------------------
# Traced runs: kernel wrappers and the profiled slice

class KernelTap:
    """Wraps the program's ``kernels.ops`` entry points: each call runs in
    a ``record_function`` range and, while ``on``, keeps its logical
    inputs (copies of the live extents, read back after the slice)."""

    def __init__(self):
        from repro_torch.kernels import ops
        from repro_torch.models import attention
        self.on = False
        self.calls = {"moe_gmm": [], "decode_attn": []}
        moe_ffn, attn = ops.moe_ffn, ops.decode_attn_auto

        def moe_ffn_tap(x, w_gate, w_up, w_down, act="swiglu",
                        group_sizes=None):
            with torch.profiler.record_function(RANGES["moe_gmm"]):
                y = moe_ffn(x, w_gate, w_up, w_down, act=act,
                            group_sizes=group_sizes)
            if self.on:
                e, c, d = x.shape
                gs = (group_sizes.clone() if group_sizes is not None
                      else torch.full((e,), c))
                self.calls["moe_gmm"].append(
                    (d, w_gate.shape[-1], x.element_size(), gs))
            return y

        def attn_tap(q, k, v, valid_len, block_s=256, return_lse=False):
            with torch.profiler.record_function(RANGES["decode_attn"]):
                out = attn(q, k, v, valid_len, block_s=block_s,
                           return_lse=return_lse)
            if self.on:
                b, h, d = q.shape
                vl = torch.as_tensor(valid_len, device=q.device).reshape(
                    -1).expand(b).clone()
                self.calls["decode_attn"].append(
                    (h, k.shape[2], d, q.element_size(), vl))
            return out
        ops.moe_ffn = moe_ffn_tap
        ops.decode_attn_auto = attention.decode_attn_auto = attn_tap

        def remove():
            ops.moe_ffn = moe_ffn
            ops.decode_attn_auto = attention.decode_attn_auto = attn
        self.remove = remove

    def costs(self) -> dict:
        out = {"moe_gmm": [], "decode_attn": []}
        for d, f, elem, gs in self.calls["moe_gmm"]:
            out["moe_gmm"].append(moe_gmm_cost(d, f, gs.tolist(), elem))
        for h, hkv, d, elem, vl in self.calls["decode_attn"]:
            out["decode_attn"].append(
                decode_attn_cost(h, hkv, d, vl.tolist(), elem))
        return out


class Slice:
    """``torch.profiler`` over the last ``length`` seconds of the window,
    so that stopping it (the profiler's own processing) delays nothing
    that the window measures; its events are read after the window."""

    def __init__(self, seconds: float, length: float, tap: KernelTap):
        self.start = max(0.0, seconds - length)
        self.tap = tap
        self.prof = None
        self.t_ns = []
        self.summary = None

    def tick(self, now: float) -> None:
        if self.prof is None and not self.t_ns and now >= self.start:
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self.t_ns.append(time.time_ns())
            self.tap.on = True

    def close(self) -> None:
        if self.prof is None:
            return
        torch.cuda.synchronize()
        self.t_ns.append(time.time_ns())
        self.tap.on = False
        self.prof.stop()
        events = self.prof.profiler.kineto_results.events()
        self.summary = trace_mod.summarize(events, self.t_ns[0],
                                           self.t_ns[1],
                                           tuple(RANGES.values()))
        self.prof = None


# ---------------------------------------------------------------------------
# The window

def _step(engine, steps, ranged):
    t = time.perf_counter()
    with ranged("engine.step"):
        engine.step()
    steps.append((t, time.perf_counter(), len(engine.queue)))


def drive_open(engine, mix, seed, vocab, seconds, drain_s, ranged, tick,
               close=lambda: None):
    sends = open_loop(mix, seed, seconds, drain_s)
    records, steps, i = [], [], 0
    waiting = []            # window requests not yet served in full
    n_window = sum(s.in_window for s in sends)
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        while i < len(sends) and sends[i].due <= now:
            s = sends[i]
            rec = _submit(engine, s, seed, vocab, t0 + s.due, s.in_window)
            records.append(rec)
            if s.in_window:
                waiting.append(rec)
            i += 1
        waiting = [r for r in waiting if not r.done]
        served_all = not waiting and len(records) >= n_window
        if served_all or now >= seconds + drain_s:
            break
        if now >= seconds:
            close()
        tick(now)
        if engine.queue or engine.num_active:
            _step(engine, steps, ranged)
        elif i < len(sends):
            with ranged("wait"):
                time.sleep(max(0.0, sends[i].due
                               - (time.perf_counter() - t0)))
        else:
            break
    return t0, records, steps


def drive_closed(engine, mix, seed, vocab, seconds, ranged, tick):
    callers = Callers(mix, seed)
    records, steps = [], []
    sent = [0] * callers.n
    inflight = {}
    t0 = time.perf_counter()

    def send(c):
        rec = _submit(engine, callers.request(c, sent[c]), seed, vocab,
                      time.perf_counter(), True)
        sent[c] += 1
        inflight[c] = rec
        records.append(rec)
    for c in range(callers.n):
        send(c)
    while True:
        now = time.perf_counter() - t0
        if now >= seconds:
            break
        tick(now)
        _step(engine, steps, ranged)
        for c, rec in list(inflight.items()):
            if rec.done:
                send(c)
    return t0, records, steps


# ---------------------------------------------------------------------------
# One run

def warm(engine, mix, vocab) -> None:
    """One prefill of every bucket the mix can send, and full-slot
    decodes, twice."""
    from repro_torch.serving import Request
    lo, hi = length_range(mix["prompt"])
    lens = [max(lo, min(b, hi)) for b in buckets(mix)]
    for _ in range(2):
        for n in lens:
            engine.submit(Request(prompt=np.arange(1, n + 1) % vocab,
                                  max_new_tokens=2))
        while engine.queue or engine.num_active:
            engine.step()
    if engine.device.type == "cuda":
        torch.cuda.synchronize()


class Harness:
    """The program set up for one cell: the model, the benchmark's weights
    (filled from ``seed``), the engine, warmed. ``trace`` attaches the
    telemetry hub and the kernel tap."""

    def __init__(self, cell: Cell, mix: dict, seed: int, device: str,
                 trace: bool):
        from repro_torch.models import Model
        from repro_torch.models.transformer import init_params
        from repro_torch.serving import (ContinuousEngine, EngineConfig,
                                         Telemetry)
        from .weights import Weights
        self.cell, self.mix, self.device = cell, mix, device
        self.cfg = model_config(cell.config)
        self.weights = Weights(init_params(self.cfg, 0, device="meta"),
                               device, self.cfg.n_layers)
        self.weights.fill(seed)
        self.tap = KernelTap() if trace else None
        self.hub = (Telemetry(capacity=1 << 18, profiler=True) if trace
                    else None)
        eng = mix["engine"]
        self.cap = int(eng["cache_cap"])
        self.engine = ContinuousEngine(
            Model(self.cfg, device=device), self.weights.params,
            batch_slots=int(eng["batch_slots"]), cache_cap=self.cap,
            config=EngineConfig(kernels=bool(eng.get("kernels", True)),
                                bucket_policy=eng.get("bucket_policy",
                                                      "pow2"),
                                telemetry=self.hub))
        self.on_card = self.engine.device.type == "cuda"
        warm(self.engine, mix, self.cfg.vocab)

    def window(self, seed: int, seconds: float, tick=lambda now: None,
               close=lambda: None):
        """Drive the engine for ``seconds`` (an open loop also until the
        window's requests are served), calling ``tick(now)`` between steps
        and ``close()`` once the window has closed. Returns (t0, records,
        steps, t_end)."""
        ranged = (torch.profiler.record_function if self.hub is not None
                  else (lambda name: nullcontext()))
        vocab = self.cfg.vocab
        if self.mix["loop"] == "open":
            t0, records, steps = drive_open(
                self.engine, self.mix, seed, vocab, seconds,
                float(self.mix.get("drain_s", 60.0)), ranged, tick, close)
        else:
            t0, records, steps = drive_closed(self.engine, self.mix, seed,
                                              vocab, seconds, ranged, tick)
        close()
        return t0, records, steps, time.perf_counter()

    def settle(self) -> None:
        """Drop what is queued and serve what is in the slots, so the next
        window starts from an idle engine."""
        self.engine.queue.clear()
        while self.engine.num_active:
            self.engine.step()

    def finished(self, records, t_end):
        """(finished window requests, failed count): an open loop's window
        requests not served in full by the end of the drain failed; a
        closed loop's requests still in flight at the close are neither."""
        window = [r for r in records if r.in_window]
        if self.mix["loop"] == "open":
            return ([r for r in window if r.done],
                    sum(not r.done for r in window))
        return [r for r in window if r.done and r.times[-1] < t_end], 0

    def compare(self, finished, failed: int, seed: int, controls=(),
                positions: dict | None = None) -> dict:
        """Per side, (each compared number beside its limit, every reading
        of the sample): "program" judges the served tokens; each precision
        in ``controls`` ("fp8": the control) judges the first choices of
        the reference computed in it, put in the program's place, by the
        same limits. The traffic file's ``check`` names the numbers
        compared and their limits (``check.judge``). A dict given as
        ``positions`` gets each side's gap at every compared position."""
        chk = self.mix["check"]
        reqs = check.sample(finished, int(chk["sample"]), seed)
        sides = {"program": None, **{p: None for p in controls}}
        if reqs:
            args = (self.cell.config, self.weights.params, reqs, self.cap,
                    self.device)
            ref = check.reference_logits(*args)
            sides["program"] = [torch.tensor(r.tokens, device=self.device)
                                for r in reqs]
            for p in controls:
                sides[p] = check.control_picks(*args, precision=p)
        out = {}
        for side, picked in sides.items():
            got = {}
            if picked is not None:
                gaps = check.gaps_of(ref, picked)
                got = check.numbers(gaps)
                if positions is not None:
                    positions[side] = torch.cat(gaps).cpu().numpy()
            got["requests"] = [[r.prompt_len, len(r.tokens)] for r in reqs]
            out[side] = (check.judge(chk["limits"], got, failed), got)
        return out


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", root: Path = ROOT,
        t_start: float | None = None) -> dict:
    """Set up, measure for ``seconds``, compare, and return the result's
    fields (``correct``, ``attempted``, ``failed``, ``metrics``,
    ``device``, with ``trace`` ``breakdown``, and last ``compared``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(workload, root)
    mix = cell.mix
    h = Harness(cell, mix, seed, device, trace)
    slicer = (Slice(seconds, float(mix.get("profile_s", 2.0)), h.tap)
              if trace and h.on_card else None)
    setup_s = time.perf_counter() - t_start
    if slicer is not None:
        t0, records, steps, t_end = h.window(seed, seconds, slicer.tick,
                                             slicer.close)
    else:
        t0, records, steps, t_end = h.window(seed, seconds)
    if h.tap is not None:
        h.tap.remove()
    peak = 0
    if h.on_card:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    spans = ([(s.name, s.ts, s.dur) for s in h.hub.spans if s.ts >= t0]
             if h.hub is not None else [])
    finished, failed = h.finished(records, t_end)
    steps_n = len(steps)

    # The program's state goes before the reference runs; the weights,
    # which the benchmark made, stay for it.
    h.engine = None
    gc.collect()
    if h.on_card:
        torch.cuda.empty_cache()
    compared, readings = h.compare(finished, failed, seed)["program"]
    correct = check.passed(compared)

    run_ = Run(seconds=seconds, setup_s=setup_s,
               t0=t0, records=records, steps=steps, spans=spans,
               kernel_calls=h.tap.costs() if slicer is not None else {},
               profile=slicer.summary if slicer is not None else None,
               flops=ModelFlops(cell.config["port"]), cap=h.cap)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"], root)(run_)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if h.on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if h.on_card else "cpu",
           "count": cell.chips if h.on_card else 1,
           "memory_peak_bytes": int(peak)}
    window = run_.window
    result = {"correct": correct, "attempted": len(window), "failed": failed,
              "metrics": metrics, "device": dev}
    info = {"steps": steps_n, "sent": len(records), "check": readings,
            "generator_lag_ms_max": 1e3 * max(
                (r.submitted - r.due for r in records), default=0.0),
            "weights_bytes": h.weights.nbytes}
    if slicer is not None and slicer.summary is not None:
        dev["busy_s"] = slicer.summary["busy_s"]
        dev["window_s"] = slicer.summary["window_s"]
        result["breakdown"] = {"device_ops": slicer.summary["device_ops"],
                               "idle_gaps": slicer.summary["idle_gaps"]}
        info["profile"] = {k: slicer.summary[k]
                           for k in ("by_range", "n_ops", "n_launches",
                                     "diag")}
        info["kernel_calls"] = {k: len(v)
                                for k, v in run_.kernel_calls.items()}
    if mix["loop"] == "open":
        for name, values in (("ttft_ms", readers.ttft_s(run_)),
                             ("itl_ms", readers.itl_s(run_))):
            info[name] = {f"p{q}": readers.tail_ms(values, q)
                          for q in (50, 90, 95, 99)}
            info[name]["tail95_mean"] = readers.tail_mean_ms(values, 95)
    result["info"] = info
    result["compared"] = compared
    return result


def banned_modules() -> list[str]:
    """Top-level names of loaded modules that a run must not load."""
    banned = {"jax", "jaxlib", "flax", "repro"}
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & banned)


def setup_env(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    and the program's sources on the path."""
    cache = root / ".perfbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
