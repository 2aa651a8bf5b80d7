"""`EdgeWorker` — one constrained edge server in the serve-time topology.

Models the three resource constraints the paper's deployment setting puts on
the strong detector's side of the link:

- **capacity**: at most ``capacity`` offloaded frames in flight at once
  (the edge GPU's concurrency budget),
- **rate**: a token bucket admitting at most ``rate`` offloads per time
  unit with burst tolerance ``burst`` — a plain
  :class:`repro_torch.core.policy.TokenBucket` in its estimate-independent
  ``try_take`` form, refilled by the simulation clock (injected, never the
  wall clock),
- **latency model**: completion time ``base + per_inflight * load`` plus
  seeded jitter, so heterogeneous edges (fast/near vs big/far) and load-
  dependent queueing are expressible,
- **link** (optional): a :class:`repro_torch.netsim.NetworkLink` fronted by a
  bounded FIFO :class:`repro_torch.netsim.UplinkQueue` — offloads first queue for
  and occupy the device→edge uplink, then run on the edge, so every
  admitted frame's latency decomposes into queue + transmit + service
  (surfaced as :class:`LatencyBreakdown` and stamped onto dispatch traces).

All timekeeping flows through the ``now`` argument of ``poll``/``try_admit``
— the worker is fully deterministic under a seeded driver.  Plain numpy,
as in the JAX package (``repro.runtime.edge``), whose jitter draws it
repeats exactly.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.policy import TokenBucket


@dataclass(frozen=True)
class EdgeLatencyModel:
    """Offload completion latency: ``base + per_inflight * inflight`` plus
    uniform seeded jitter in ``[0, jitter)``."""

    base: float = 1.0
    per_inflight: float = 0.0
    jitter: float = 0.0

    def __post_init__(self) -> None:
        for name in ("base", "per_inflight", "jitter"):
            v = getattr(self, name)
            if not np.isfinite(v) or v < 0.0:
                raise ValueError(
                    f"EdgeLatencyModel.{name} must be finite and >= 0, got {v}"
                )

    def sample(self, inflight: int, rng: np.random.Generator) -> float:
        lat = self.base + self.per_inflight * inflight
        if self.jitter > 0.0:
            lat += self.jitter * float(rng.uniform())
        return lat


@dataclass(frozen=True)
class LatencyBreakdown:
    """Where one offload's latency went: uplink queue wait, transmission,
    edge service, and (on downlink-fronted edges) the return transit of the
    result — the detections also pay transmission before they count.
    Link-free edges report pure service."""

    queue: float
    transmit: float
    service: float
    downlink: float = 0.0

    @property
    def total(self) -> float:
        return self.queue + self.transmit + self.service + self.downlink

    def as_dict(self) -> Dict[str, float]:
        return {
            "queue": self.queue,
            "transmit": self.transmit,
            "service": self.service,
            "downlink": self.downlink,
        }


@dataclass(frozen=True)
class CompletedJob:
    """One finished offload: arrival step, admit/finish times, serving edge."""

    step: int
    edge: str
    t_admit: float
    t_done: float


class EdgeWorker:
    """One edge server with capacity, rate limit, and a latency model.

    Parameters
    ----------
    name : str
        Unique id within a dispatcher fleet.
    capacity : int
        Max concurrent in-flight offloads.
    rate : float or None
        Admissions per time unit (token bucket, burst ``burst``); ``None``
        disables rate limiting.
    burst : float
        Token-bucket depth (burst tolerance) when ``rate`` is set.
    latency : EdgeLatencyModel
    link : repro_torch.netsim.NetworkLink or None
        Optional uplink model.  When set, every admission first traverses a
        bounded FIFO :class:`repro_torch.netsim.UplinkQueue` over this link:
        admission can additionally fail because the uplink queue is full
        (``queue_depth``), and the returned latency is queue wait +
        transmission + service (breakdown in ``last_breakdown``).
    queue_depth : int
        Uplink queue bound (frames queued-or-transmitting) when ``link`` is
        set.
    frame_bits : float
        Default offloaded-frame size on the link (``try_admit`` may
        override per frame).
    downlink : repro_torch.netsim.NetworkLink or None
        Optional edge→device **return** channel.  When set, each completed
        offload's result (``result_bits``) traverses a bounded FIFO
        :class:`repro_torch.netsim.DownlinkQueue` before the device counts it:
        the returned latency additionally includes the downlink sojourn
        (``breakdown.downlink``), and admission pre-checks the downlink
        queue the same way it pre-checks the uplink.
    downlink_depth : int
        Downlink queue bound (results queued-or-transmitting) when
        ``downlink`` is set.
    result_bits : float
        Returned-result size on the downlink (detections are far smaller
        than the frames that produced them).
    seed : int
        Seeds the jitter stream; two workers with equal config + seed are
        step-for-step identical.
    """

    def __init__(
        self,
        name: str,
        *,
        capacity: int = 4,
        rate: Optional[float] = None,
        burst: float = 4.0,
        latency: Optional[EdgeLatencyModel] = None,
        link: Optional["NetworkLink"] = None,
        queue_depth: int = 16,
        frame_bits: float = 1.0,
        downlink: Optional["NetworkLink"] = None,
        downlink_depth: int = 32,
        result_bits: float = 0.25,
        seed: int = 0,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.name = str(name)
        self.capacity = int(capacity)
        self.latency = latency if latency is not None else EdgeLatencyModel()
        if link is not None:
            from repro_torch.netsim.queue import UplinkQueue

            self.uplink: Optional[UplinkQueue] = UplinkQueue(
                link, depth=queue_depth, frame_bits=frame_bits
            )
        else:
            self.uplink = None
        if downlink is not None:
            from repro_torch.netsim.queue import DownlinkQueue

            self.downlink: Optional[DownlinkQueue] = DownlinkQueue(
                downlink, depth=downlink_depth, frame_bits=result_bits
            )
        else:
            self.downlink = None
        self.last_breakdown: Optional[LatencyBreakdown] = None
        self._tracer: Optional[Any] = None
        self._tid = 0
        self._rng = np.random.default_rng(seed)
        self._now = 0.0
        # min-heap of (t_done, step, t_admit); admit time rides in the entry
        # so concurrent sessions may reuse step indices without collisions
        self._inflight: List[tuple] = []
        self.completed: List[CompletedJob] = []
        self.accepted = 0
        self.rejected = 0
        self.cancelled = 0
        self._bucket: Optional[TokenBucket] = (
            TokenBucket(
                rate=float(rate),
                depth=float(burst),
                base_threshold=0.0,
                clock=lambda: self._now,
            )
            if rate is not None
            else None
        )

    # --------------------------------------------------------------- obs

    def attach_obs(self, obs: Optional[Any], tid: int = 0) -> None:
        """Wire this edge into an observability handle: live callback
        gauges over its existing counters (no hot-path mutation anywhere)
        and a trace track (``tid``) for its offload span groups."""
        if obs is None:
            return
        self._tracer = obs.tracer
        self._tid = int(tid)
        if self._tracer is not None:
            self._tracer.thread_name(self._tid, f"edge:{self.name}")
        reg = obs.metrics
        if reg is not None:
            labels = {"edge": self.name}
            reg.gauge(
                "repro_edge_inflight", labels,
                help="offloads currently running on the edge",
                fn=lambda: len(self._inflight),
            )
            reg.gauge(
                "repro_edge_queue_depth", labels,
                help="frames queued or transmitting on the uplink",
                fn=lambda: self.uplink.occupancy if self.uplink is not None else 0,
            )
            reg.gauge(
                "repro_edge_accepted", labels,
                help="offloads admitted so far", fn=lambda: self.accepted,
            )
            reg.gauge(
                "repro_edge_rejected", labels,
                help="offloads refused so far", fn=lambda: self.rejected,
            )

    # ------------------------------------------------------------------ time

    def _advance(self, now: float) -> None:
        self._now = max(self._now, float(now))

    def poll(self, now: float) -> List[CompletedJob]:
        """Complete every in-flight offload with finish time <= ``now``."""
        self._advance(now)
        if self.uplink is not None:
            self.uplink.poll(self._now)
        if self.downlink is not None:
            self.downlink.poll(self._now)
        done: List[CompletedJob] = []
        while self._inflight and self._inflight[0][0] <= self._now:
            t_done, step, t_admit = heapq.heappop(self._inflight)
            job = CompletedJob(
                step=step, edge=self.name, t_admit=t_admit, t_done=t_done,
            )
            done.append(job)
            self.completed.append(job)
            if self._tracer is not None:
                self._tracer.instant(
                    "result.return", t=t_done, tid=self._tid,
                    args={"step": step},
                )
        return done

    # ------------------------------------------------------------- admission

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    @property
    def load(self) -> float:
        """Fraction of capacity in use (0 = idle, 1 = saturated)."""
        return len(self._inflight) / self.capacity

    def expected_latency(self) -> float:
        """Deterministic part of the next job's latency (dispatch weighting);
        includes the predicted uplink sojourn on link-fronted edges."""
        service = self.latency.base + self.latency.per_inflight * len(self._inflight)
        if self.uplink is not None:
            service += self.uplink.predicted_sojourn(self._now)
        if self.downlink is not None:
            service += self.downlink.predicted_sojourn(self._now)
        return service

    def predicted_uplink_delay(self, now: float) -> float:
        """Predicted uplink *queueing* wait for a frame offered now — the
        avoidable part of the sojourn (a frame's own transmission is paid
        regardless of when it offloads).  0 on link-free edges.  The
        congestion signal queue-aware policies discount by."""
        if self.uplink is None:
            return 0.0
        return self.uplink.predicted_wait(max(self._now, float(now)))

    def uplink_state(self, now: float) -> Tuple[int, int]:
        """Observed ``(queue_depth, channel_state)`` at ``now`` — the MDP
        state the ``value_iteration`` policy conditions on.  Link-free edges
        report ``(0, good)``."""
        if self.uplink is None:
            return 0, 0
        t = max(self._now, float(now))
        self.uplink.poll(t)
        return self.uplink.occupancy, self.uplink.link.state_at(t)

    def try_admit(
        self,
        now: float,
        step: int,
        estimate: float,
        size_bits: Optional[float] = None,
    ) -> Optional[float]:
        """Admit one offload; returns its latency, or ``None`` when the edge
        refuses (capacity full, the rate limiter withholds a token, or the
        uplink/downlink queue is full).  The estimate is recorded on the
        trace, not used for admission.  On success ``last_breakdown`` holds
        the queue/transmit/service(/downlink) decomposition of the returned
        latency — on downlink-fronted edges the result's return transit is
        part of the latency, because a detection the device has not received
        yet serves nothing."""
        self.poll(now)
        if len(self._inflight) >= self.capacity:
            self.rejected += 1
            return None
        # pre-check the queues BEFORE the rate limiter: a full queue must
        # not burn a token on a frame it is about to refuse
        if self.uplink is not None and self.uplink.full(self._now):
            self.rejected += 1
            return None
        if self.downlink is not None and self.downlink.full(self._now):
            self.rejected += 1
            return None
        if self._bucket is not None and not self._bucket.try_take():
            self.rejected += 1
            return None
        if self.uplink is not None:
            frame = self.uplink.enqueue(self._now, int(step), size_bits)
            if frame is None:  # unreachable: fullness checked at this `now`
                self.rejected += 1
                return None
            service = self.latency.sample(len(self._inflight), self._rng)
            queue_delay, transmit_delay = frame.queue_delay, frame.transmit_delay
            t_ready = frame.t_delivered + service
        else:
            service = self.latency.sample(len(self._inflight), self._rng)
            queue_delay = transmit_delay = 0.0
            t_ready = self._now + service
        downlink_delay = 0.0
        if self.downlink is not None:
            # the whole schedule is known at admit time (deterministic
            # links), so the result's return leg is priced now: it enters
            # the downlink when service completes and pays FIFO transit
            result = self.downlink.enqueue(t_ready, int(step))
            if result is None:  # unreachable: fullness checked above
                self.rejected += 1
                return None
            downlink_delay = result.sojourn
            t_ready = result.t_delivered
        self.last_breakdown = LatencyBreakdown(
            queue=queue_delay,
            transmit=transmit_delay,
            service=service,
            downlink=downlink_delay,
        )
        lat = t_ready - self._now
        heapq.heappush(self._inflight, (self._now + lat, int(step), self._now))
        self.accepted += 1
        if self._tracer is not None:
            # the simulator knows the job's whole extent at admit time, so
            # the span group is synthesized here: an async `offload` slice
            # with nested queue → transmit → service children (async so
            # concurrent jobs on one edge can overlap without mis-nesting)
            tr = self._tracer
            bd = self.last_breakdown
            t0, t1 = self._now, self._now + lat
            jid = tr.next_id()
            tr.add_async_span(
                "offload", t0, t1, id=jid, tid=self._tid,
                args={"step": int(step), "edge": self.name},
            )
            tq = t0 + bd.queue
            tt = tq + bd.transmit
            ts = tt + bd.service
            tr.add_async_span("queue", t0, tq, id=jid, tid=self._tid)
            tr.add_async_span("transmit", tq, tt, id=jid, tid=self._tid)
            tr.add_async_span("service", tt, ts, id=jid, tid=self._tid)
            if bd.downlink > 0.0:
                tr.add_async_span("downlink", ts, t1, id=jid, tid=self._tid)
        return lat

    def cancel_steps(self, steps: "set[int]") -> int:
        """Drop the in-flight offloads whose step ids are in ``steps`` —
        the *die* in-flight semantics of a mid-stream edge handover: results
        still being computed for (or transiting back to) a client that left
        this edge's coverage are abandoned, never delivered.  Returns the
        number cancelled.  Queue occupancy is left untouched: the frames
        already crossed (or are crossing) the radio — only the delivery is
        suppressed."""
        keep = [e for e in self._inflight if e[1] not in steps]
        n = len(self._inflight) - len(keep)
        if n:
            self._inflight = keep
            heapq.heapify(self._inflight)
            self.cancelled += n
        return n

    # ----------------------------------------------------------------- stats

    def stats(self) -> Dict[str, Any]:
        out = {
            "capacity": self.capacity,
            "accepted": self.accepted,
            "rejected": self.rejected,
            "completed": len(self.completed),
            "inflight": len(self._inflight),
        }
        if self.cancelled:
            out["cancelled"] = self.cancelled
        if self.uplink is not None:
            out["uplink"] = self.uplink.stats()
        if self.downlink is not None:
            out["downlink"] = self.downlink.stats()
        return out
