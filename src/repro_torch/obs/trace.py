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

Copied from the JAX package (``repro.obs.trace``).
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional

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
        if clock is None:
            clock = time.perf_counter
            ts_scale = WALL_TS_SCALE if ts_scale is None else ts_scale
        else:
            ts_scale = SIM_TS_SCALE if ts_scale is None else ts_scale
        self.clock = clock
        self.ts_scale = float(ts_scale)
        self.max_events = int(max_events)
        self.events: List[Dict[str, Any]] = []
        self.dropped = 0
        self._thread_names: Dict[int, str] = {}
        self._seq = 0

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

    def thread_name(self, tid: int, name: str) -> None:
        """Name a track (Chrome ``M``/``thread_name`` metadata event)."""
        self._thread_names[int(tid)] = str(name)

    def _push(self, ev: Dict[str, Any]) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

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
            "ts": float(t0) * self.ts_scale,
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
            "ts": float(self.clock() if t is None else t) * self.ts_scale,
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
            "ts": float(t0) * self.ts_scale, **base,
        }
        if args:
            b["args"] = args
        self._push(b)
        self._push(
            {
                "name": str(name), "ph": "e",
                "ts": float(t1) * self.ts_scale, **base,
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

    def to_chrome(self) -> Dict[str, Any]:
        """``{"traceEvents": [...]}`` — metadata events first, then spans
        in recording order (stable: recording order is deterministic under
        the manual clock)."""
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
