"""The device trace of a traced window (``torch.profiler``, CPU and CUDA
activity), reduced to what the per-layer metrics read: device time and
launch count by kernel name, the busy time (the union of every device
operation's interval: kernels, copies, sets), and the breakdown the result
line carries: the device operations that took most time, and the device's
idle time by what the host was doing meanwhile (the innermost host
operation open at each gap's midpoint, or ``host (no op)``).
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


def _events(prof):
    """(device [(start, end, name)], host [(start, end, name)]) in seconds,
    from the profiler's raw Kineto events.  Device events are the kernels,
    copies and sets; the device-side copies of host annotations (which span
    whole ranges of the timeline) are left out, by their activity type
    where this PyTorch exposes it, else by the annotation names seen on the
    host."""
    from torch.autograd import DeviceType

    dev, host, notes = [], [], set()
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9
        kind = e.activity_type() if hasattr(e, "activity_type") else None
        if e.device_type() == DeviceType.CUDA:
            if kind is None or kind in DEVICE_ACTIVITIES:
                dev.append((start, end, e.name()))
        else:
            host.append((start, end, e.name()))
            if kind == "user_annotation" or (kind is None and e.name() == WINDOW):
                notes.add(e.name())
    return [d for d in dev if d[2] not in notes], host


def short_name(name: str, cap: int = 160) -> str:
    """A kernel's name without ``void`` and its argument list, at most
    ``cap`` characters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i else name
                break
    return name.removeprefix("void ")[:cap]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _host_at(host_sorted, starts, t: float) -> str:
    """The innermost host operation open at ``t`` (latest start, covering
    t); host events are few per gap, so a short backward scan suffices."""
    i = bisect.bisect_right(starts, t) - 1
    best = None
    for j in range(i, max(i - 200, -1), -1):
        s, e, name = host_sorted[j]
        if e >= t:
            best = name
            break
    return best or "host (no op)"


def reduce(prof) -> Dict:
    """Reduce a profile whose window is the host annotation ``WINDOW``
    (``torch.profiler.record_function``), on the profiler's own clock."""
    dev, host = _events(prof)
    marks = [(s, e) for s, e, name in host if name == WINDOW]
    if len(marks) != 1:
        raise RuntimeError(f"the trace holds {len(marks)} '{WINDOW}' annotations, not 1")
    (t0, t1), = marks
    host = [h for h in host if h[2] != WINDOW]
    dev = [d for d in dev if d[1] > t0 and d[0] < t1]
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for s, e, name in dev:
        by_name[name][0] += 1
        by_name[name][1] += e - s
    busy = _union([(max(s, t0), min(e, t1)) for s, e, _ in dev])
    busy_s = sum(e - s for s, e in busy)
    gaps = []
    prev = t0
    for s, e in busy + [(t1, t1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    host.sort()
    starts = [h[0] for h in host]
    idle_by: Dict[str, float] = defaultdict(float)
    for s, e in gaps:
        idle_by[_host_at(host, starts, 0.5 * (s + e))] += e - s
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    top_gaps = sorted(idle_by.items(), key=lambda kv: -kv[1])[:10]
    return {
        "kernels": {k: (int(v[0]), float(v[1])) for k, v in by_name.items()},
        "busy_s": busy_s,
        "window_s": t1 - t0,
        "breakdown": {"device_ops": [[short_name(k), v[1]] for k, v in top_ops],
                      "idle_gaps": [[k, v] for k, v in top_gaps]},
    }


def kernel_time(kernels: Dict, part: str) -> Tuple[int, float]:
    """(launches, device seconds) of the kernels whose name holds ``part``."""
    n, s = 0, 0.0
    for name, (c, t) in kernels.items():
        if part in name:
            n += c
            s += t
    return n, s
