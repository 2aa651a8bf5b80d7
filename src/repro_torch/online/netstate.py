"""Measured network-state estimation from realized offload completions.

The netsim policies (``queue_aware``, ``value_iteration``) consume
*oracle* probes today: ``OffloadRuntime._congestion`` reads the simulator's
own ``predicted_uplink_delay`` and ``_state_probe`` reads the true
``(queue_depth, channel_state)`` — signals a real device cannot see.  What
a device *can* see is each offload's round trip: when it sent the frame,
when the result came back, and (from response metadata) how the latency
decomposed.  SmartDet's conclusion (PAPERS.md) is that exactly these
context signals must be tracked at runtime rather than probed.

:class:`NetworkEstimator` is that tracker:

- **RTT**: TCP-style SRTT/RTTVAR exponential estimators over completed
  round trips (RFC 6298 weighting).
- **Bandwidth**: EWMA of ``bits / transmit_delay`` per delivered frame.
- **Queue sojourn**: EWMA of the uplink queue wait component of each
  round trip (telemetry / diagnostics).
- **Congestion**: an in-flight census — 0 while any uplink is free, else
  the per-link backlog times the smoothed transmission time.  Frames in
  flight are known at *send* time, so this leads the round-trip evidence
  by a full RTT and tracks the oracle probe's sharp on/off shape.

**Causality on the manual clock**: a completion recorded at send time
``t_sent`` with round trip ``rtt`` only becomes *visible* to the estimators
at ``t_sent + rtt`` — samples sit in a pending heap and drain against the
injected clock, so the estimator never sees the future and seeded replays
are exact.  ``congestion()`` / ``state_probe()`` are drop-in replacements
for the runtime's oracle probes (``OffloadRuntime(net_state=...)`` swaps
them in).

Copied from the JAX package (``repro.online.netstate``): host numpy over
the port's ``LatencyBreakdown``; ``OffloadRuntime(net_state=...)`` binds it
to the runtime's manual clock and fleet.
"""
from __future__ import annotations

import heapq
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.runtime.edge import LatencyBreakdown

# RFC 6298 smoothing weights
_SRTT_ALPHA = 0.125
_RTTVAR_BETA = 0.25


class NetworkEstimator:
    """Rolling RTT / bandwidth / queue-sojourn estimators over completed
    offloads, with send-time causality on an injected manual clock.

    Parameters
    ----------
    alpha : float
        EWMA weight on the newest queue/transmit/bandwidth sample.
    parallelism : int
        Uplinks the fleet serves in parallel (frames in flight up to this
        count imply no queueing).  ``bind_fleet`` sets it from the runtime.
    pressure : float
        Weight of the in-flight backlog term in :meth:`congestion`: with
        every uplink busy, the estimate is ``pressure * (outstanding /
        parallelism) * transmit_ewma``.
    clock : callable or None
        Zero-arg time source (the runtime's ``ManualClock``); samples only
        become visible once the clock passes their delivery time.
    """

    def __init__(
        self,
        *,
        alpha: float = 0.3,
        parallelism: int = 1,
        pressure: float = 1.0,
        clock: Optional[Callable[[], float]] = None,
    ):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self.parallelism = max(int(parallelism), 1)
        self.pressure = float(pressure)
        self._clock = clock
        # pending completions: (t_visible, seq, rtt, queue, transmit, service, bits)
        self._pending: List[tuple] = []
        self._seq = 0  # heap tie-breaker, part of serialized state
        self.srtt: Optional[float] = None
        self.rttvar = 0.0
        self.queue_ewma = 0.0
        self.transmit_ewma = 0.0
        self.service_ewma = 0.0
        self.bw_ewma = 0.0
        self.min_transmit = np.inf
        self.delivered = 0

    # --------------------------------------------------------------- wiring

    def bind_clock(self, clock: Callable[[], float]) -> None:
        self._clock = clock

    def bind_fleet(self, n_edges: int) -> None:
        self.parallelism = max(int(n_edges), 1)

    # -------------------------------------------------------------- feeding

    def record(
        self,
        t_sent: float,
        rtt: float,
        breakdown: Optional[LatencyBreakdown] = None,
        bits: float = 1.0,
    ) -> None:
        """Register one completed offload sent at ``t_sent`` with round trip
        ``rtt``.  The sample becomes visible at ``t_sent + rtt`` — the
        moment the result (and its latency metadata) physically arrives."""
        rtt = float(rtt)
        if not np.isfinite(rtt) or rtt < 0.0:
            return
        q = float(breakdown.queue) if breakdown is not None else 0.0
        tx = float(breakdown.transmit) if breakdown is not None else 0.0
        sv = float(breakdown.service) if breakdown is not None else rtt
        heapq.heappush(
            self._pending,
            (float(t_sent) + rtt, self._seq, rtt, q, tx, sv, float(bits)),
        )
        self._seq += 1

    def _now(self) -> float:
        if self._clock is None:
            return np.inf  # unclocked: everything recorded is visible
        return float(self._clock())

    def poll(self, now: Optional[float] = None) -> int:
        """Fold every pending sample delivered by ``now`` into the
        estimators (in delivery order); returns how many arrived."""
        t = self._now() if now is None else float(now)
        n = 0
        a = self.alpha
        while self._pending and self._pending[0][0] <= t:
            _, _, rtt, q, tx, sv, bits = heapq.heappop(self._pending)
            if self.srtt is None:
                self.srtt = rtt
                self.rttvar = rtt / 2.0
                self.queue_ewma, self.transmit_ewma, self.service_ewma = q, tx, sv
            else:
                self.rttvar = (1.0 - _RTTVAR_BETA) * self.rttvar + _RTTVAR_BETA * abs(
                    self.srtt - rtt
                )
                self.srtt = (1.0 - _SRTT_ALPHA) * self.srtt + _SRTT_ALPHA * rtt
                self.queue_ewma = (1.0 - a) * self.queue_ewma + a * q
                self.transmit_ewma = (1.0 - a) * self.transmit_ewma + a * tx
                self.service_ewma = (1.0 - a) * self.service_ewma + a * sv
            if tx > 0.0:
                bw = bits / tx
                self.bw_ewma = bw if self.delivered == 0 or self.bw_ewma == 0.0 else (
                    (1.0 - a) * self.bw_ewma + a * bw
                )
                self.min_transmit = min(self.min_transmit, tx)
            self.delivered += 1
            n += 1
        return n

    # -------------------------------------------------------------- queries

    @property
    def outstanding(self) -> int:
        """Offloads sent whose results have not yet arrived (at the bound
        clock's current time)."""
        t = self._now()
        return sum(1 for p in self._pending if p[0] > t)

    def rtt(self) -> float:
        """Smoothed round-trip estimate (0 before any completion)."""
        self.poll()
        return float(self.srtt) if self.srtt is not None else 0.0

    def rto(self) -> float:
        """RFC 6298 retransmission-style timeout: ``srtt + 4·rttvar``."""
        self.poll()
        if self.srtt is None:
            return 0.0
        return float(self.srtt + 4.0 * self.rttvar)

    def bandwidth(self) -> float:
        """Smoothed goodput estimate in bits per time unit (0 before any
        link-fronted completion)."""
        self.poll()
        return float(self.bw_ewma)

    def congestion(self) -> float:
        """Measured stand-in for the oracle ``predicted_uplink_delay``
        probe, built entirely from what the device knows *at send time*:
        how many offloads are in flight and how long a transmission has
        been taking.  While any uplink is free a new frame starts
        immediately — congestion 0, exactly like the oracle's empty-queue
        reading.  Once every uplink is busy, the per-link backlog is
        ``outstanding / parallelism`` transmissions of ``transmit_ewma``
        each.  The gate matters: smoothing past queue waits into the
        estimate (the obvious choice) keeps it elevated after queues
        drain, deferring the budget controller's payback into the next
        burst — the sharp in-flight census tracks the oracle's shape."""
        self.poll()
        if self.outstanding < self.parallelism:
            return 0.0
        backlog = self.outstanding / self.parallelism
        return float(self.pressure * backlog * self.transmit_ewma)

    def state_probe(self) -> Tuple[int, int]:
        """Measured stand-in for the oracle ``(queue_depth, channel_state)``
        probe: queue depth from the congestion estimate in units of one
        transmission, channel bad when smoothed transmit times run well
        above the best observed (a fade roughly multiplies them)."""
        self.poll()
        if self.transmit_ewma <= 0.0:
            return 0, 0
        depth = int(round(self.congestion() / self.transmit_ewma))
        bad = int(
            np.isfinite(self.min_transmit)
            and self.transmit_ewma > 1.5 * self.min_transmit
        )
        return depth, bad

    def telemetry(self) -> Dict[str, float]:
        self.poll()
        return {
            "rtt": self.rtt(),
            "rttvar": float(self.rttvar),
            "bandwidth": self.bandwidth(),
            "queue_sojourn": float(self.queue_ewma),
            "congestion": self.congestion(),
            "outstanding": float(self.outstanding),
            "delivered": float(self.delivered),
        }

    # ------------------------------------------------------------ persistence

    def state(self) -> Dict[str, np.ndarray]:
        pending = np.asarray(
            sorted(self._pending), np.float64
        ).reshape(-1, 7)
        return {
            "pending": pending,
            "scalars": np.asarray(
                [
                    self.srtt if self.srtt is not None else np.nan,
                    self.rttvar,
                    self.queue_ewma,
                    self.transmit_ewma,
                    self.service_ewma,
                    self.bw_ewma,
                    self.min_transmit,
                ],
                np.float64,
            ),
            "counters": np.asarray([self._seq, self.delivered], np.int64),
        }

    @classmethod
    def from_state(
        cls,
        state: Dict[str, np.ndarray],
        *,
        alpha: float = 0.3,
        parallelism: int = 1,
        pressure: float = 1.0,
        clock: Optional[Callable[[], float]] = None,
    ) -> "NetworkEstimator":
        est = cls(alpha=alpha, parallelism=parallelism, pressure=pressure, clock=clock)
        pending = np.asarray(state["pending"], np.float64).reshape(-1, 7)
        est._pending = [
            (row[0], int(row[1]), row[2], row[3], row[4], row[5], row[6])
            for row in pending
        ]
        heapq.heapify(est._pending)
        s = np.asarray(state["scalars"], np.float64)
        est.srtt = None if np.isnan(s[0]) else float(s[0])
        est.rttvar = float(s[1])
        est.queue_ewma = float(s[2])
        est.transmit_ewma = float(s[3])
        est.service_ewma = float(s[4])
        est.bw_ewma = float(s[5])
        est.min_transmit = float(s[6])
        c = np.asarray(state["counters"], np.int64)
        est._seq = int(c[0])
        est.delivered = int(c[1])
        return est
