"""`UplinkQueue` — the FIFO device→edge transmission queue.

One transmitter, one queue: a frame enqueued at ``t`` waits for every frame
ahead of it, then occupies the link for its own transmission time.  Because
the discipline is FIFO and link bandwidth is a deterministic function of
time (see :mod:`repro_torch.netsim.link`), the full schedule of a frame —
``t_start`` and ``t_delivered`` — is computable *at enqueue time*; ``poll``
then just surfaces deliveries as the simulation clock passes them.  That
keeps the queue event-driven and wall-clock-free like everything under
``repro_torch.runtime``: all timekeeping flows through explicit ``now``
arguments (a :class:`repro_torch.runtime.clock.ManualClock` in simulations).

Accounting is conservative by construction: every frame offered to
``enqueue`` is exactly one of **delivered** (eventually, once polled past
its ``t_delivered``) or **dropped** (bounded ``depth`` exceeded at arrival)
— property-tested in ``tests/test_netsim.py``.

Copied from the JAX package (``repro.netsim.queue``); plain Python.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, Optional

from repro_torch.netsim.link import NetworkLink


@dataclass(frozen=True)
class TransmittedFrame:
    """One frame's uplink story: sojourn = queue wait + transmission."""

    step: int
    size_bits: float
    t_enqueue: float
    t_start: float
    t_delivered: float

    @property
    def queue_delay(self) -> float:
        return self.t_start - self.t_enqueue

    @property
    def transmit_delay(self) -> float:
        return self.t_delivered - self.t_start

    @property
    def sojourn(self) -> float:
        return self.t_delivered - self.t_enqueue


class UplinkQueue:
    """Bounded FIFO in front of a :class:`NetworkLink`.

    Parameters
    ----------
    link : NetworkLink
        Deterministic bandwidth model; transmission of a frame is priced at
        the bandwidth holding when the frame *starts* transmitting.
    depth : int
        Max frames queued-or-transmitting at once; an arrival that finds
        ``depth`` frames in the system is dropped (counted, never silently).
    frame_bits : float
        Default frame size when ``enqueue`` is not given one.
    """

    def __init__(self, link: NetworkLink, *, depth: int = 16, frame_bits: float = 1.0):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if frame_bits < 0.0:
            raise ValueError(f"frame_bits must be >= 0, got {frame_bits}")
        self.link = link
        self.depth = int(depth)
        self.frame_bits = float(frame_bits)
        self._now = 0.0
        self._busy_until = 0.0
        self._pending: Deque[TransmittedFrame] = deque()  # scheduled, undelivered
        self.delivered: List[TransmittedFrame] = []
        self.enqueued = 0
        self.dropped = 0

    # ------------------------------------------------------------------ time

    def _advance(self, now: float) -> None:
        self._now = max(self._now, float(now))

    def poll(self, now: float) -> List[TransmittedFrame]:
        """Surface every frame whose transmission completed by ``now``."""
        self._advance(now)
        done: List[TransmittedFrame] = []
        while self._pending and self._pending[0].t_delivered <= self._now:
            f = self._pending.popleft()
            done.append(f)
            self.delivered.append(f)
        return done

    # ------------------------------------------------------------- admission

    @property
    def occupancy(self) -> int:
        """Frames queued or transmitting (delivery not yet polled past)."""
        return len(self._pending)

    def full(self, now: float) -> bool:
        """Would an arrival at ``now`` be dropped?  Polls to ``now`` first,
        so admission pipelines can pre-check without spending other
        resources (rate tokens) on a frame the queue would refuse."""
        self.poll(now)
        return len(self._pending) >= self.depth

    def enqueue(
        self, now: float, step: int, size_bits: Optional[float] = None
    ) -> Optional[TransmittedFrame]:
        """Offer one frame; returns its full (deterministic) schedule, or
        ``None`` when the bounded queue is full and the frame is dropped."""
        self.poll(now)
        if len(self._pending) >= self.depth:
            self.dropped += 1
            return None
        size = self.frame_bits if size_bits is None else float(size_bits)
        t_start = max(self._now, self._busy_until)
        t_delivered = t_start + self.link.transmit_delay(size, t_start)
        frame = TransmittedFrame(
            step=int(step), size_bits=size, t_enqueue=self._now,
            t_start=t_start, t_delivered=t_delivered,
        )
        self._busy_until = t_delivered
        self._pending.append(frame)
        self.enqueued += 1
        return frame

    # ------------------------------------------------------------ prediction

    def predicted_wait(self, now: float) -> float:
        """Queueing delay a frame offered at ``now`` would see before its
        transmission starts (0 when the link is idle).  Pure — no state
        change beyond lazy channel materialization."""
        return max(self._busy_until - max(self._now, float(now)), 0.0)

    def predicted_sojourn(self, now: float, size_bits: Optional[float] = None) -> float:
        """Predicted wait + own transmission time for a frame offered at
        ``now`` — the congestion signal queue-aware policies discount by."""
        t = max(self._now, float(now))
        wait = self.predicted_wait(t)
        size = self.frame_bits if size_bits is None else float(size_bits)
        return wait + self.link.transmit_delay(size, t + wait)

    # ----------------------------------------------------------------- stats

    def stats(self) -> Dict[str, Any]:
        return {
            "depth": self.depth,
            "enqueued": self.enqueued,
            "delivered": len(self.delivered),
            "dropped": self.dropped,
            "occupancy": len(self._pending),
        }


class DownlinkQueue(UplinkQueue):
    """The edge→device **return** channel: detections coming back also pay
    transit before they count.

    Mechanically identical to :class:`UplinkQueue` (one transmitter, FIFO,
    bounded, deterministic enqueue-time schedules, conservative
    delivered+dropped==enqueued accounting) — the subclass exists so
    topologies read correctly and so result frames get their own default
    size: a detection list is much smaller than the image that produced it,
    so ``frame_bits`` here defaults to a quarter of the uplink convention.

    One semantic difference of *use*, not mechanics: results are enqueued
    at their **service-completion** time, which for concurrently admitted
    offloads need not be monotone in admission order.  The queue serializes
    them in enqueue-call order (``t_start = max(ready, busy_until)``) — the
    return channel is one radio, and the schedule stays deterministic
    because :class:`~repro_torch.runtime.edge.EdgeWorker` enqueues at admission
    time, in admission order.
    """

    def __init__(self, link: NetworkLink, *, depth: int = 32, frame_bits: float = 0.25):
        super().__init__(link, depth=depth, frame_bits=frame_bits)
