"""Streaming serve-time API on top of the frozen ``OffloadEngine``.

The engine (``repro_torch.api``) is the fitted decision artifact; this
package is the *served system* around it — the paper's deployment setting
made explicit:

- :class:`OffloadSession` — stateful per-stream wrapper (micro-batched
  scoring through the ``estimator_mlp`` kernel, or ``score_pipeline`` for a
  whole detection block, arrival-order policy state, rolling telemetry,
  mid-stream ``set_ratio``),
- :class:`EdgeWorker` / :class:`EdgeLatencyModel` — a constrained edge
  server (capacity, clock-driven token-bucket rate limit, latency model,
  optional ``link=`` uplink front-end from :mod:`repro_torch.netsim` with a
  bounded FIFO queue and per-frame :class:`LatencyBreakdown`),
- :class:`MultiEdgeDispatcher` — routes accepted offloads across a
  heterogeneous fleet (``round_robin`` / ``least_loaded`` /
  ``score_weighted``) with drop-or-degrade on saturation,
- :class:`OffloadRuntime` / :func:`simulate` — the deterministic seeded
  end-to-end driver producing exact per-step :class:`StreamTrace` records.

Every layer accepts an optional ``obs=`` :class:`repro_torch.obs.Obs`
handle (re-exported here): metrics registry + manual-clock span tracing +
host-phase profiling, noop-by-default.
"""
from repro_torch.obs import Obs
from repro_torch.runtime.clock import ManualClock
from repro_torch.runtime.dispatch import (
    OUTCOME_DEGRADED,
    OUTCOME_DROPPED,
    OUTCOME_LOCAL,
    OUTCOME_OFFLOADED,
    DispatchResult,
    MultiEdgeDispatcher,
    list_strategies,
)
from repro_torch.runtime.edge import (
    CompletedJob,
    EdgeLatencyModel,
    EdgeWorker,
    LatencyBreakdown,
)
from repro_torch.runtime.session import OffloadSession, SessionTelemetry, StepDecision
from repro_torch.runtime.simulate import (
    OffloadRuntime,
    StepRecord,
    StreamTrace,
    default_congested_fleet,
    default_edge_fleet,
    default_linked_fleet,
    simulate,
)

__all__ = [
    "ManualClock",
    "Obs",
    "OffloadSession",
    "SessionTelemetry",
    "StepDecision",
    "EdgeWorker",
    "EdgeLatencyModel",
    "LatencyBreakdown",
    "CompletedJob",
    "MultiEdgeDispatcher",
    "DispatchResult",
    "list_strategies",
    "OUTCOME_LOCAL",
    "OUTCOME_OFFLOADED",
    "OUTCOME_DEGRADED",
    "OUTCOME_DROPPED",
    "OffloadRuntime",
    "StepRecord",
    "StreamTrace",
    "default_edge_fleet",
    "default_congested_fleet",
    "default_linked_fleet",
    "simulate",
]
