"""Reading a ``torch.profiler`` slice of a traced run.

The profiler records host ranges (``record_function``: the telemetry hub's
step spans, the harness's own ranges and the kernel wrappers' ranges),
the CUDA runtime's launch calls and the device's kernels, copies and
fills. From them:

- ``busy_s``: the union of the device's operations over the slice;
- ``by_range``: device seconds of the operations launched inside each
  kernel wrapper's range (a launch is matched to its operation by the
  runtime's correlation id, or else by the host range the profiler links
  the operation to), so a kernel is timed whatever its name;
- ``device_ops``: the operations that took most time, by name;
- ``idle_gaps``: the device's idle time, summed by the innermost host
  range that was open (a gap that spans several is split among them).

All times are in seconds; the profiler's clock is the epoch in ns, as
``time.time_ns`` reads it.
"""

from __future__ import annotations

import bisect
import collections

_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
             "cuLaunchKernelEx")


def _is_cuda(ev) -> bool:
    return str(ev.device_type()).endswith("CUDA")


def _kind(ev) -> str:
    """The event's activity kind where the profiler reports one (torch
    2.11's events have none), else ""."""
    kind = getattr(ev, "activity_type", None)
    return str(kind()).lower() if kind is not None else ""


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(ranges):
    """Sorted boundaries [(t, name)] of the innermost open host range from
    properly nested (start, end, name) ranges ("" where none is open)."""
    marks = []
    for a, b, name in ranges:
        marks.append((a, 1, -b, name))
        marks.append((b, 0, 0, name))
    marks.sort()
    stack, out = [], []
    for t, opening, _, name in marks:
        if opening:
            stack.append(name)
        elif name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]
        out.append((t, stack[-1] if stack else ""))
    return out


def summarize(events, t0_ns: int, t1_ns: int, range_names=()) -> dict:
    """``events``: the profiler's kineto events; [t0, t1]: the slice, on
    the host's epoch clock. Should the device's timestamps run on another
    base (a launch would then start its operation before it was made, or
    far after), they are moved by the least launch-to-start delay."""
    ops, annotations, launches, ann_ids = [], [], {}, {}
    for ev in events:
        a = ev.start_ns()
        b = a + ev.duration_ns()
        if _is_cuda(ev):
            ops.append((a, b, ev.name(), ev.correlation_id(),
                        ev.linked_correlation_id(), _kind(ev)))
        elif ev.is_user_annotation():
            annotations.append((a, b, ev.name()))
            ann_ids[ev.correlation_id()] = ev.name()
        elif ev.name() in _LAUNCHES:
            launches[ev.correlation_id()] = a
    # The device's mirror of a host range is no operation.
    host_names = {n for _, _, n in annotations}
    ops = [o[:5] for o in ops
           if "annotation" not in o[5] and o[2] not in host_names]
    delays = sorted(a - launches[c] for a, _, _, c, _ in ops
                    if c in launches)
    shift = delays[0] if delays and not 0 <= delays[0] < 50_000_000 else 0
    diag = {"clock_shift_ns": shift,
            "launch_to_start_ns": (
                [delays[0], delays[len(delays) // 2], delays[-1]]
                if delays else None)}
    ops = [(max(a - shift, t0_ns), min(b - shift, t1_ns), *rest)
           for a, b, *rest in ops]
    ops = [o for o in ops if o[1] > o[0]]
    busy = _union((a, b) for a, b, *_ in ops)
    busy_ns = sum(b - a for a, b in busy)

    by_name = collections.Counter()
    for a, b, name, *_ in ops:
        by_name[name] += (b - a) * 1e-9

    by_range = {}
    for rname in range_names:
        spans = sorted((a, b) for a, b, n in annotations if n == rname)
        starts = [a for a, _ in spans]
        secs, n_ops = 0.0, 0
        for a, b, _, corr, linked in ops:
            t = launches.get(corr)
            if t is None:       # no runtime event: the op's host parent
                inside = ann_ids.get(linked) == rname
            else:
                i = bisect.bisect_right(starts, t) - 1
                inside = i >= 0 and spans[i][0] <= t <= spans[i][1]
            if inside:
                secs += (b - a) * 1e-9
                n_ops += 1
        by_range[rname] = {"seconds": secs, "ops": n_ops,
                           "ranges": len(spans)}

    marks = _innermost([r for r in annotations
                        if r[2] not in range_names])
    times = [t for t, _ in marks]
    gaps = collections.Counter()
    edges = [t0_ns] + [x for a, b in busy for x in (a, b)] + [t1_ns]
    for a, b in zip(edges[::2], edges[1::2]):
        i = bisect.bisect_right(times, a) - 1
        while a < b:            # split the gap where the host range changes
            end = min(b, times[i + 1]) if i + 1 < len(times) else b
            name = marks[i][1] if i >= 0 and marks[i][1] else "no host range"
            gaps[name] += (end - a) * 1e-9
            a, i = end, i + 1
    return {"busy_s": busy_ns * 1e-9, "window_s": (t1_ns - t0_ns) * 1e-9,
            "device_ops": [[n, s] for n, s in by_name.most_common(10)],
            "idle_gaps": [[n, s] for n, s in gaps.most_common(10)],
            "by_range": by_range, "n_ops": len(ops),
            "n_launches": len(launches), "diag": diag}
