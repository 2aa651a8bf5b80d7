"""`MetricsRegistry` — the serve stack's one metric surface.

Three instrument kinds, chosen so the serve hot loop never allocates:

- :class:`Counter` — a monotone accumulator (``inc``).  Stays an ``int``
  under integer increments, so telemetry views built over counters keep
  their exact historical payloads (``processed: 512``, never ``512.0``).
- :class:`Gauge` — a last-write-wins value (``set``), or a *callback*
  gauge (``fn=``) evaluated at collection time — the zero-hot-path-cost
  way to expose live state (queue occupancy, realized ratios, kernel launch
  counts) without instrumenting every mutation site.
- :class:`Histogram` — fixed upper-bound buckets with the counts in one
  preallocated ``numpy`` ``int64`` array; ``observe`` is a ``bisect`` +
  two scalar adds, no per-observation dict or list churn.

Instruments are plain objects: they can live **unregistered** (a session
with observability disabled keeps its telemetry counters as private,
detached instruments — same write path, nothing collected) or be created
through a :class:`MetricsRegistry`, which is what the exporters walk.
There is deliberately no global default registry: a registry's lifetime is
a run's lifetime, and two concurrent simulations must not share one.

Snapshot/delta semantics: :meth:`MetricsRegistry.snapshot` materializes
every instrument into a plain dict (deterministically ordered), and
:meth:`MetricsRegistry.delta` diffs two snapshots — how benchmarks report
"what this phase did" without resetting anything.  Exporters:
:meth:`to_prometheus` (text exposition format) and :meth:`to_json`.

Copied from the JAX package (``repro.obs.metrics``); plain numpy.
"""
from __future__ import annotations

import json
from bisect import bisect_left
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

LabelPairs = Tuple[Tuple[str, str], ...]

#: default latency-ish buckets in simulation time units (RTT, sojourn)
DEFAULT_TIME_BUCKETS: Tuple[float, ...] = (
    0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
)


def _labels_key(labels: Optional[Dict[str, str]]) -> LabelPairs:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _format_labels(labels: LabelPairs) -> str:
    if not labels:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + body + "}"


def _format_value(v: Any) -> str:
    """Prometheus sample value: integers stay integral, floats use repr
    (shortest round-trip form, deterministic)."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if f != f:  # NaN
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f)


class Counter:
    """A monotone accumulator.  ``value`` stays ``int`` under integer
    increments (telemetry byte-stability depends on it)."""

    __slots__ = ("name", "labels", "help", "value")
    kind = "counter"

    def __init__(self, name: str, labels: LabelPairs = (), help: str = ""):
        self.name = name
        self.labels = labels
        self.help = help
        self.value: Any = 0

    def inc(self, n: Any = 1) -> None:
        self.value += n

    def collect(self) -> Any:
        return self.value


class Gauge:
    """Last-write-wins value, or a collection-time callback (``fn``)."""

    __slots__ = ("name", "labels", "help", "_value", "fn")
    kind = "gauge"

    def __init__(
        self,
        name: str,
        labels: LabelPairs = (),
        help: str = "",
        fn: Optional[Callable[[], Any]] = None,
    ):
        self.name = name
        self.labels = labels
        self.help = help
        self._value: Any = 0
        self.fn = fn

    def set(self, v: Any) -> None:
        self._value = v

    @property
    def value(self) -> Any:
        """The current reading — the callback's, when one is bound."""
        if self.fn is not None:
            return self.fn()
        return self._value

    def collect(self) -> Any:
        return self.value


class Histogram:
    """Fixed-bucket histogram: ``buckets`` are sorted upper bounds, counts
    live in one preallocated ``int64`` array (+1 overflow bin for values
    above the last bound).  ``observe`` allocates nothing."""

    __slots__ = ("name", "labels", "help", "buckets", "counts", "sum", "n")
    kind = "histogram"

    def __init__(
        self,
        name: str,
        buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
        labels: LabelPairs = (),
        help: str = "",
    ):
        edges = tuple(float(b) for b in buckets)
        if not edges or any(nxt <= prev for nxt, prev in zip(edges[1:], edges)):
            raise ValueError(f"buckets must be strictly increasing, got {buckets}")
        self.name = name
        self.labels = labels
        self.help = help
        self.buckets = edges
        self.counts = np.zeros(len(edges) + 1, np.int64)
        self.sum = 0.0
        self.n = 0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.n += 1

    @property
    def mean(self) -> float:
        return self.sum / self.n if self.n else 0.0

    def collect(self) -> Dict[str, Any]:
        return {
            "buckets": list(self.buckets),
            "counts": self.counts.tolist(),
            "sum": self.sum,
            "count": self.n,
        }


class MetricsRegistry:
    """Instrument factory + walkable collection surface.

    ``counter``/``gauge``/``histogram`` are get-or-create keyed on
    ``(name, labels)`` — calling twice returns the same instrument, so
    decoupled components can share a metric without passing objects
    around.  ``collector(fn)`` registers a callable returning extra
    ``(name, labels_dict, value, kind)`` rows evaluated at export time
    (how kernel launch and build counts surface without any hot-path hook).
    """

    def __init__(self) -> None:
        self._metrics: Dict[Tuple[str, LabelPairs], Any] = {}
        self._collectors: List[Callable[[], List[Tuple[str, Dict[str, str], Any, str]]]] = []

    # ------------------------------------------------------------- factories

    def _get_or_make(self, cls, name: str, labels, **kw):
        key = (str(name), _labels_key(labels))
        inst = self._metrics.get(key)
        if inst is None:
            inst = cls(key[0], labels=key[1], **kw)
            self._metrics[key] = inst
        elif not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as {inst.kind}, "
                f"not {cls.kind}"
            )
        return inst

    def counter(
        self, name: str, labels: Optional[Dict[str, str]] = None, help: str = ""
    ) -> Counter:
        return self._get_or_make(Counter, name, labels, help=help)

    def gauge(
        self,
        name: str,
        labels: Optional[Dict[str, str]] = None,
        help: str = "",
        fn: Optional[Callable[[], Any]] = None,
    ) -> Gauge:
        g = self._get_or_make(Gauge, name, labels, help=help)
        if fn is not None:
            # callback gauges rebind freely: a fresh fleet re-registering
            # the same metric name must observe the *new* object's state
            g.fn = fn
        return g

    def histogram(
        self,
        name: str,
        buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
        labels: Optional[Dict[str, str]] = None,
        help: str = "",
    ) -> Histogram:
        return self._get_or_make(Histogram, name, labels, help=help, buckets=buckets)

    def collector(
        self, fn: Callable[[], List[Tuple[str, Dict[str, str], Any, str]]]
    ) -> None:
        self._collectors.append(fn)

    # ------------------------------------------------------------ collection

    def _rows(self) -> List[Tuple[str, LabelPairs, Any, str, str]]:
        """(name, labels, value, kind, help) for every instrument +
        collector row, deterministically ordered."""
        rows = [
            (m.name, m.labels, m.collect(), m.kind, m.help)
            for m in self._metrics.values()
        ]
        for fn in self._collectors:
            for name, labels, value, kind in fn():
                rows.append((str(name), _labels_key(labels), value, kind, ""))
        rows.sort(key=lambda r: (r[0], r[1]))
        return rows

    def snapshot(self) -> Dict[str, Any]:
        """Every metric materialized into plain Python, keyed
        ``name{label="v",...}`` — the delta/export substrate."""
        return {
            f"{name}{_format_labels(labels)}": value
            for name, labels, value, _, _ in self._rows()
        }

    @staticmethod
    def delta(prev: Dict[str, Any], cur: Dict[str, Any]) -> Dict[str, Any]:
        """cur - prev for numeric series (new keys pass through; histogram
        states diff their counts/sum/count)."""
        out: Dict[str, Any] = {}
        for key, value in cur.items():
            base = prev.get(key)
            if base is None:
                out[key] = value
            elif isinstance(value, dict) and isinstance(base, dict):
                out[key] = {
                    "buckets": value["buckets"],
                    "counts": [
                        c - p for c, p in zip(value["counts"], base["counts"])
                    ],
                    "sum": value["sum"] - base["sum"],
                    "count": value["count"] - base["count"],
                }
            elif isinstance(value, (int, float)) and isinstance(base, (int, float)):
                out[key] = value - base
            else:
                out[key] = value
        return out

    # ------------------------------------------------------------- exporters

    def to_prometheus(self) -> str:
        """Prometheus text exposition (0.0.4): HELP/TYPE per family once,
        histogram as cumulative ``_bucket{le=}`` + ``_sum``/``_count``."""
        lines: List[str] = []
        seen_family: set = set()
        for name, labels, value, kind, help_ in self._rows():
            if name not in seen_family:
                seen_family.add(name)
                if help_:
                    lines.append(f"# HELP {name} {help_}")
                lines.append(f"# TYPE {name} {kind}")
            if kind == "histogram":
                cum = 0
                for le, c in zip(value["buckets"], value["counts"]):
                    cum += c
                    le_labels = labels + (("le", _format_value(float(le))),)
                    # keep label order deterministic: le is appended last
                    lines.append(
                        f"{name}_bucket{_format_labels(le_labels)} {cum}"
                    )
                inf_labels = labels + (("le", "+Inf"),)
                lines.append(
                    f"{name}_bucket{_format_labels(inf_labels)} {value['count']}"
                )
                lines.append(
                    f"{name}_sum{_format_labels(labels)} {_format_value(value['sum'])}"
                )
                lines.append(
                    f"{name}_count{_format_labels(labels)} {value['count']}"
                )
            else:
                lines.append(
                    f"{name}{_format_labels(labels)} {_format_value(value)}"
                )
        return "\n".join(lines) + ("\n" if lines else "")

    def to_json(self) -> Dict[str, Any]:
        """A structured export: one entry per series with kind + value."""
        series = [
            {
                "name": name,
                "labels": {k: v for k, v in labels},
                "kind": kind,
                "value": value,
            }
            for name, labels, value, kind, _ in self._rows()
        ]
        return {"series": series}

    def export_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
