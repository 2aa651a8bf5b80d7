"""Mid-stream edge migration: the hysteresis trigger and in-flight semantics.

A moving client's serving station is chosen by the classic A3-style rule:
hand over when some *other* station's signal beats the serving one by at
least ``hysteresis_db`` — and only after ``min_dwell`` time units on the
current server, so a client skirting a cell boundary doesn't ping-pong.
The controller is pure bookkeeping over signals the :class:`CoverageMap`
computes; it never touches edges itself.

What happens to offloads **in flight** on the old edge is configurable —
the three semantics the acceptance tests pin (see docs/API.md for the
table):

- ``"survive"`` — make-before-break: results complete on the old edge and
  are delivered normally (the old downlink still reaches the client).
- ``"die"``     — break-before-make: the old edge's in-flight work for this
  stream is cancelled (:meth:`EdgeWorker.cancel_steps`); those frames'
  results never arrive and their coverage is lost.
- ``"stale"``   — results survive but arrive aged by ``stale_penalty``
  frames (forwarded through the core network after the radio drops), so
  the video staleness machinery discounts them on delivery.

The *application* of these semantics lives in the runtime that owns the
pending-results ledger (:class:`repro_torch.mobility.runtime.MobileRuntime`);
:func:`apply_in_flight` is the shared implementation so tests can drive it
directly against a hand-built ledger.

Copied from the JAX package (``repro.mobility.handover``): host numpy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.mobility.coverage import CoverageMap

IN_FLIGHT = ("survive", "die", "stale")


@dataclass(frozen=True)
class HandoverEvent:
    """One executed migration, stamped in simulation time."""

    t: float
    source: int
    target: int
    rss_source: float
    rss_target: float

    def as_dict(self) -> Dict[str, Any]:
        return {
            "t": self.t,
            "source": self.source,
            "target": self.target,
            "rss_source": self.rss_source,
            "rss_target": self.rss_target,
        }


@dataclass
class PendingResult:
    """One offloaded frame whose result has not been delivered yet — the
    runtime's ledger entry the in-flight semantics operate on."""

    t_done: float        # simulation time the result reaches the client
    capture_step: int    # frame index the result covers from
    step: int            # dispatch step id (for cancel_steps)
    edge: int            # fleet index serving the offload


class HandoverController:
    """Per-stream serving-station state machine.

    Parameters
    ----------
    coverage : CoverageMap
    hysteresis_db : float
        Margin a challenger must beat the serving signal by.
    min_dwell : float
        Minimum time between handovers (simulation time units).
    in_flight : str
        One of :data:`IN_FLIGHT`; what the runtime does to the old edge's
        outstanding results at the moment of migration.
    stale_penalty : int
        Frames of extra staleness under the ``"stale"`` semantics.
    """

    def __init__(
        self,
        coverage: CoverageMap,
        *,
        hysteresis_db: float = 4.0,
        min_dwell: float = 8.0,
        in_flight: str = "survive",
        stale_penalty: int = 4,
    ):
        if in_flight not in IN_FLIGHT:
            raise KeyError(
                f"unknown in-flight semantics {in_flight!r}; have {list(IN_FLIGHT)}"
            )
        if hysteresis_db < 0 or min_dwell < 0 or stale_penalty < 0:
            raise ValueError("hysteresis_db, min_dwell, stale_penalty must be >= 0")
        self.coverage = coverage
        self.hysteresis_db = float(hysteresis_db)
        self.min_dwell = float(min_dwell)
        self.in_flight = in_flight
        self.stale_penalty = int(stale_penalty)
        self.serving: Optional[int] = None
        self.last_rss = float("nan")
        self.events: List[HandoverEvent] = []
        self._attached_at = -np.inf

    def update(self, now: float, pos: np.ndarray) -> Optional[HandoverEvent]:
        """Observe the signal at ``pos``; attach on first call (not counted
        as a handover), migrate when the hysteresis rule fires.  Returns
        the event when one fired, else ``None``."""
        rss = self.coverage.rss(np.asarray(pos, np.float64))
        if self.serving is None:
            self.serving = int(np.argmax(rss))
            self.last_rss = float(rss[self.serving])
            self._attached_at = float(now)
            return None
        best = int(np.argmax(rss))
        self.last_rss = float(rss[self.serving])
        if (
            best != self.serving
            and float(rss[best]) - float(rss[self.serving]) > self.hysteresis_db
            and float(now) - self._attached_at >= self.min_dwell
        ):
            ev = HandoverEvent(
                t=float(now),
                source=self.serving,
                target=best,
                rss_source=float(rss[self.serving]),
                rss_target=float(rss[best]),
            )
            self.events.append(ev)
            self.serving = best
            self.last_rss = float(rss[best])
            self._attached_at = float(now)
            return ev
        return None

    def spec(self) -> Dict[str, Any]:
        return {
            "hysteresis_db": self.hysteresis_db,
            "min_dwell": self.min_dwell,
            "in_flight": self.in_flight,
            "stale_penalty": self.stale_penalty,
        }


def apply_in_flight(
    pending: List[PendingResult],
    event: HandoverEvent,
    mode: str,
    *,
    stale_penalty: int = 4,
    edges: Optional[Any] = None,
) -> Tuple[List[PendingResult], int]:
    """Apply one migration's in-flight semantics to a stream's pending
    ledger.  Returns ``(new_ledger, n_affected)`` where affected means
    cancelled (``die``) or aged (``stale``).  With ``edges`` (the fleet
    list), ``die`` also cancels the jobs on the old
    :class:`~repro_torch.runtime.edge.EdgeWorker` so its in-flight slots free up
    — exactly the accounting a dropped radio bearer implies."""
    if mode not in IN_FLIGHT:
        raise KeyError(f"unknown in-flight semantics {mode!r}; have {list(IN_FLIGHT)}")
    hit = [p for p in pending if p.edge == event.source]
    if mode == "survive" or not hit:
        return list(pending), 0
    if mode == "die":
        if edges is not None:
            edges[event.source].cancel_steps({p.step for p in hit})
        return [p for p in pending if p.edge != event.source], len(hit)
    # stale: results are tunneled through the core network after the radio
    # drops — they arrive, but older: ageing the capture step by the
    # penalty is exactly how the video staleness machinery will see it
    for p in hit:
        p.capture_step -= int(stale_penalty)
    return list(pending), len(hit)
