"""`repro_torch.obs` — one observability plane for the serve stack.

Everything the runtime emits flows through a single :class:`Obs` handle
threaded as an optional ``obs=`` argument through ``OffloadSession``,
``OffloadRuntime`` and ``EdgeWorker`` / ``MultiEdgeDispatcher``:

    from repro_torch.obs import Obs
    obs = Obs()
    trace = simulate(engine, features=x, obs=obs)
    print(obs.metrics.to_prometheus())
    obs.tracer.export("trace.json")     # open in Perfetto
    print(obs.profiler.format_report())

``obs=None`` (the default everywhere) is the noop: instrumented code
guards every emission behind one ``is None`` check.

Three sub-planes, each independently disableable:

- :attr:`Obs.metrics` — a :class:`~repro_torch.obs.metrics.MetricsRegistry`
  (counters/gauges/fixed-bucket histograms, Prometheus-text + JSON
  exporters).  Session telemetry counters become registry-backed
  instruments when an obs handle is attached, so ``to_prometheus()``
  exposes live realized ratios, offload decisions, queue depths, and RTT
  histograms with no double accounting.
- :attr:`Obs.tracer` — a :class:`~repro_torch.obs.trace.Tracer` stamping
  nested spans from the simulation's ``ManualClock`` (byte-identical
  traces under a fixed seed) or ``perf_counter`` in benchmarks,
  exported as Chrome-trace JSON.
- :attr:`Obs.profiler` — a :class:`~repro_torch.obs.profiler.DispatchProfiler`
  attributing host-loop wall time to named serve phases.

Kernel visibility rides along for free: ``Obs`` snapshots the wrappers'
launch counters and the kernel builds (:mod:`repro_torch.obs.kernel_stats`)
at construction and exports ``repro_kernel_launches_total{kernel=...}`` (and
``repro_kernel_builds_total{source=...}`` where a library was compiled) as
the growth since then — where the JAX package exports its jit retraces.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.obs import kernel_stats
from repro_torch.obs.metrics import (
    DEFAULT_TIME_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.profiler import DispatchProfiler
from repro_torch.obs.trace import SIM_TS_SCALE, WALL_TS_SCALE, Tracer

__all__ = [
    "Obs",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "Tracer",
    "DispatchProfiler",
    "kernel_stats",
    "DEFAULT_TIME_BUCKETS",
    "SIM_TS_SCALE",
    "WALL_TS_SCALE",
]


class Obs:
    """The observability handle runtimes accept as ``obs=``.

    ``Obs()`` enables all three planes.  ``Obs(tracing=False)`` etc.
    disable one — the corresponding attribute is ``None`` and
    instrumented code skips its emissions (the same guard as
    ``obs=None``, applied per plane).  :meth:`Obs.noop` disables all
    three while still exercising the seam.
    """

    __slots__ = ("metrics", "tracer", "profiler", "_kernel_baseline")

    def __init__(
        self,
        *,
        metrics: bool = True,
        tracing: bool = True,
        profiling: bool = True,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.metrics: Optional[MetricsRegistry] = MetricsRegistry() if metrics else None
        self.tracer: Optional[Tracer] = Tracer(clock=clock) if tracing else None
        self.profiler: Optional[DispatchProfiler] = (
            DispatchProfiler() if profiling else None
        )
        # launches are reported relative to handle construction: the
        # wrappers' counters are process-global, the handle scopes them
        self._kernel_baseline = kernel_stats.snapshot()
        if self.metrics is not None:
            self.metrics.collector(self._collect_kernels)

    @classmethod
    def noop(cls) -> "Obs":
        """All planes disabled — the seam is exercised, nothing is
        recorded."""
        return cls(metrics=False, tracing=False, profiling=False)

    @property
    def enabled(self) -> bool:
        return (
            self.metrics is not None
            or self.tracer is not None
            or self.profiler is not None
        )

    def bind_clock(
        self, clock: Callable[[], float], ts_scale: float = SIM_TS_SCALE
    ) -> None:
        """Attach the simulation clock (runtimes call this so spans are
        stamped in simulated, not wall, time)."""
        if self.tracer is not None:
            self.tracer.bind_clock(clock, ts_scale)

    # --------------------------------------------------------- kernel plane

    def kernel_delta(self) -> kernel_stats.Snapshot:
        """Launches per kernel and builds per source since this handle was
        built."""
        return kernel_stats.delta(self._kernel_baseline, kernel_stats.snapshot())

    def _collect_kernels(self) -> List[Tuple[str, Dict[str, str], Any, str]]:
        delta = self.kernel_delta()
        rows: List[Tuple[str, Dict[str, str], Any, str]] = [
            ("repro_kernel_launches_total", {"kernel": k}, n, "counter")
            for k, n in sorted(delta["launches"].items())
        ]
        rows += [
            ("repro_kernel_builds_total", {"source": k}, n, "counter")
            for k, n in sorted(delta["builds"].items()) if n
        ]
        return rows
