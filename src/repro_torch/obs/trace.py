"""`Tracer` — nested spans over an injectable clock, exported as
Chrome-trace JSON (loads in Perfetto / ``chrome://tracing``).

The serve stack has two time regimes and one tracer serves both:

- **Simulation**: everything is stamped from the runtime's
  :class:`~repro_torch.runtime.clock.ManualClock` — a run is deterministic, so
  the trace is *byte-identical* across repeats with the same seed.  The
  runtimes call :meth:`Tracer.bind_clock` when they bind their own clock.
- **Benchmarks / wall-clock**: with no bound clock the tracer falls back
  to ``time.perf_counter``.

Spans are recorded as Chrome ``ph="X"`` *complete* events (one event
carrying ``ts`` + ``dur``), which lets the simulator synthesize spans for
things it already knows the full extent of (an edge job's
queue/transmit/service decomposition is known at admit time) without a
begin/end protocol.  Nesting is by containment per ``tid`` — Perfetto
stacks overlapping same-thread slices automatically, so a session flush
span on the session track visually contains its per-frame dispatch
instants, and an edge's ``offload`` span contains its
``queue``/``transmit``/``service`` children.

Timestamps: Chrome traces use microseconds.  Simulation time units are
treated as milliseconds (the runtime's latency models speak ms), so
``ts = clock() * 1e3 * 1e3``; wall-clock spans use seconds → µs.

**One clock with the device trace.**  A wall-clock tracer pairs, at
construction, ``perf_counter_ns`` with the profiler's host clock (Kineto
stamps host events in epoch nanoseconds, ``time.time_ns``) and records its
wall-clock events on the profiler's clock, so an exported trace and
``torch.profiler``'s ``export_chrome_trace`` line up in Perfetto.  A
tracer on a bound (simulation) clock records that clock's time unshifted.

**Stages.**  :func:`stage` opens one span of the serve path's work and
switches on three ways: with a tracer it records a complete span (its
parent's ``id``, the tree's ``batch`` id, and, given a CUDA ``device``, the
device interval between two CUDA events recorded on the current stream,
resolved when the tracer is read, never on the hot path); while
``torch.profiler`` records it is also a host range of the same name in the
profiler's trace; given ``stage_ms`` and a ``key`` it waits for the device
at open and close and adds the host milliseconds under ``key``.  With all
three off it returns one shared null context.

Copied from the JAX package (``repro.obs.trace``); the clock anchor and
:func:`stage` are the port's.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional

import torch
from torch._C._profiler import _RecordFunctionFast

#: True while torch.profiler records (one C call; 0.25 us)
profiler_active = torch.autograd._profiler_enabled

#: trace ts is µs; manual-clock units are ms → µs
SIM_TS_SCALE = 1e3
#: perf_counter is seconds → µs
WALL_TS_SCALE = 1e6


class Tracer:
    """Collects spans/instants and serializes Chrome-trace JSON.

    ``clock`` is any zero-arg callable returning the current time;
    ``ts_scale`` converts that unit into microseconds.  ``max_events``
    bounds memory on long runs (oldest events are *not* rotated — the
    tracer simply stops recording and counts the overflow, keeping the
    head of the timeline which is what regressions get diagnosed from).
    """

    def __init__(
        self,
        clock: Optional[Callable[[], float]] = None,
        ts_scale: Optional[float] = None,
        max_events: int = 200_000,
    ):
        #: True while spans are stamped from ``perf_counter`` (not a bound
        #: simulation clock): the events are then on the profiler's clock
        self.wall = clock is None
        self._offset = 0.0
        if clock is None:
            clock = time.perf_counter
            ts_scale = WALL_TS_SCALE if ts_scale is None else ts_scale
            p0 = time.perf_counter_ns()
            epoch = time.time_ns()
            p1 = time.perf_counter_ns()
            # µs to add to perf_counter's µs to land on the profiler's clock
            self._offset = (epoch - (p0 + p1) // 2) / 1e3
        else:
            ts_scale = SIM_TS_SCALE if ts_scale is None else ts_scale
        self.clock = clock
        self.ts_scale = float(ts_scale)
        self.max_events = int(max_events)
        self.events: List[Dict[str, Any]] = []
        self.dropped = 0
        self._thread_names: Dict[int, str] = {}
        self._seq = 0
        self._open: List["_Stage"] = []     # the stages open now, outermost first
        self._pending: List[tuple] = []     # (event, start, end): device intervals to resolve

    def next_id(self) -> int:
        """Monotone id for async span groups — unique within the tracer,
        deterministic (allocation order is the recording order)."""
        self._seq += 1
        return self._seq

    # ------------------------------------------------------------ recording

    def bind_clock(
        self, clock: Callable[[], float], ts_scale: float = SIM_TS_SCALE
    ) -> None:
        """Swap the time source (runtimes attach their ManualClock here)."""
        self.clock = clock
        self.ts_scale = float(ts_scale)
        self.wall = False
        self._offset = 0.0

    def thread_name(self, tid: int, name: str) -> None:
        """Name a track (Chrome ``M``/``thread_name`` metadata event)."""
        self._thread_names[int(tid)] = str(name)

    def _push(self, ev: Dict[str, Any]) -> bool:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return False
        self.events.append(ev)
        return True

    def _ts(self, t: float) -> float:
        ts = float(t) * self.ts_scale
        return ts + self._offset if self.wall else ts

    def add_span(
        self,
        name: str,
        t0: float,
        t1: float,
        tid: int = 0,
        args: Optional[Dict[str, Any]] = None,
    ) -> None:
        """A complete span over ``[t0, t1]`` in clock units — the way the
        simulator emits spans whose extent it already knows."""
        ev: Dict[str, Any] = {
            "name": str(name),
            "ph": "X",
            "ts": self._ts(t0),
            "dur": max(float(t1) - float(t0), 0.0) * self.ts_scale,
            "pid": 0,
            "tid": int(tid),
        }
        if args:
            ev["args"] = args
        self._push(ev)

    def instant(
        self,
        name: str,
        t: Optional[float] = None,
        tid: int = 0,
        args: Optional[Dict[str, Any]] = None,
    ) -> None:
        """A zero-duration marker (``ph="i"``, thread-scoped)."""
        ev: Dict[str, Any] = {
            "name": str(name),
            "ph": "i",
            "s": "t",
            "ts": self._ts(self.clock() if t is None else t),
            "pid": 0,
            "tid": int(tid),
        }
        if args:
            ev["args"] = args
        self._push(ev)

    def add_async_span(
        self,
        name: str,
        t0: float,
        t1: float,
        id: int,
        cat: str = "offload",
        tid: int = 0,
        args: Optional[Dict[str, Any]] = None,
    ) -> None:
        """A begin/end async pair (``ph="b"``/``"e"``).  Async events with
        the same ``(cat, id)`` nest by b/e ordering on their own lane, so
        concurrent edge jobs — whose extents partially overlap and would
        mis-nest as same-track complete events — each get a correctly
        nested ``offload ⊃ queue/transmit/service`` group."""
        base = {"cat": str(cat), "id": int(id), "pid": 0, "tid": int(tid)}
        b: Dict[str, Any] = {
            "name": str(name), "ph": "b",
            "ts": self._ts(t0), **base,
        }
        if args:
            b["args"] = args
        self._push(b)
        self._push(
            {
                "name": str(name), "ph": "e",
                "ts": self._ts(t1), **base,
            }
        )

    @contextmanager
    def span(self, name: str, tid: int = 0, **args: Any):
        """Clock-stamped span around a block (used where the extent is not
        known up front — wall-clock benchmark sections, adaptive updates)."""
        t0 = self.clock()
        try:
            yield
        finally:
            self.add_span(name, t0, self.clock(), tid=tid, args=args or None)

    # ------------------------------------------------------------- exporting

    def resolve(self) -> None:
        """Write each stage's device interval (``args["device_ms"]``): waits
        for the last recorded CUDA event, so call it once the work is done
        (every reader below does)."""
        for ev, start, end in self._pending:
            end.synchronize()
            ev["args"]["device_ms"] = start.elapsed_time(end)
        self._pending.clear()

    def spans(self, name: str) -> List[Dict[str, Any]]:
        """The complete spans called ``name``, in recording order, with
        their device intervals resolved."""
        self.resolve()
        return [e for e in self.events if e["ph"] == "X" and e["name"] == name]

    def to_chrome(self) -> Dict[str, Any]:
        """``{"traceEvents": [...]}`` — metadata events first, then spans
        in recording order (stable: recording order is deterministic under
        the manual clock)."""
        self.resolve()
        meta = [
            {
                "name": "thread_name",
                "ph": "M",
                "pid": 0,
                "tid": tid,
                "args": {"name": name},
            }
            for tid, name in sorted(self._thread_names.items())
        ]
        events = meta + self.events
        if self.dropped:
            events.append(
                {
                    "name": "trace_overflow",
                    "ph": "M",
                    "pid": 0,
                    "tid": 0,
                    "args": {"dropped": self.dropped},
                }
            )
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1, sort_keys=True)

    def clear(self) -> None:
        self.events.clear()
        self.dropped = 0
        self._thread_names.clear()
        self._pending.clear()


#: the profiler's host range of a stage: a plain op range, which the profiler
#: does not mirror onto the device timeline (a ``record_function`` user
#: annotation gets a device-side row spanning its kernels, which a reader of
#: the device trace would count as work)
_HostRange = _RecordFunctionFast


def _device_event(device: Optional[torch.device]):
    if device is None or device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _NullStage:
    """What :func:`stage` returns with every switch off."""

    __slots__ = ()

    def __enter__(self) -> "_NullStage":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **args: Any) -> None:
        pass


NULL_STAGE = _NullStage()


class _Stage:
    __slots__ = ("tracer", "name", "stage_ms", "key", "device", "args",
                 "_range", "_t0", "_ms0", "_ev0")

    def __init__(self, tracer, name, stage_ms, key, device, args):
        self.tracer, self.name, self.device, self.args = tracer, name, device, args
        self.stage_ms, self.key = (stage_ms, key) if key is not None else (None, None)
        self._range = self._ev0 = None

    def set(self, **args: Any) -> None:
        """Add args to the span (recorded when it closes)."""
        self.args.update(args)

    def __enter__(self) -> "_Stage":
        if self.stage_ms is not None:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._ms0 = time.perf_counter()
        if profiler_active():
            self._range = _HostRange(self.name)
            self._range.__enter__()
        tr = self.tracer
        if tr is not None:
            sid = tr.next_id()
            parent = tr._open[-1] if tr._open else None
            head = {"id": sid, "batch": parent.args["batch"] if parent is not None else sid}
            if parent is not None:
                head["parent"] = parent.args["id"]
            self.args = {**head, **self.args}
            tr._open.append(self)
            self._ev0 = _device_event(self.device)
            self._t0 = tr.clock()
        return self

    def __exit__(self, *exc) -> bool:
        tr = self.tracer
        if tr is not None:
            end = _device_event(self.device) if self._ev0 is not None else None
            t1 = tr.clock()
            tr._open.pop()
            ev = {"name": self.name, "ph": "X", "ts": tr._ts(self._t0),
                  "dur": max(t1 - self._t0, 0.0) * tr.ts_scale, "pid": 0, "tid": 0,
                  "args": self.args}
            if tr._push(ev) and end is not None:
                tr._pending.append((ev, self._ev0, end))
        if self._range is not None:
            self._range.__exit__(None, None, None)
        if self.stage_ms is not None:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            ms = (time.perf_counter() - self._ms0) * 1e3
            self.stage_ms[self.key] = self.stage_ms.get(self.key, 0.0) + ms
        return False


def stage(tracer: Optional[Tracer], name: str, *, stage_ms: Optional[Dict[str, float]] = None,
          key: Optional[str] = None, device: Optional[torch.device] = None, **args: Any):
    """A context around one stage of work; see the module docstring.
    ``args`` ride on the tracer's span (``set`` adds more before it
    closes); a root span's ``batch`` is its own ``id`` and every span
    inside it carries the same ``batch``.  Only the spans that carry a
    ``key`` synchronise, and only when ``stage_ms`` is given."""
    if tracer is None and (stage_ms is None or key is None) and not profiler_active():
        return NULL_STAGE
    return _Stage(tracer, name, stage_ms, key, device, args)
