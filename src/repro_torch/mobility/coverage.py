"""Base-station placements and position-dependent link quality.

The radio model is the standard log-distance path loss: a station
transmitting at ``tx_power_dbm`` is received at

    rss(d) = tx_power_dbm - ref_loss_db - 10 * path_loss_exp * log10(max(d, 1))

(dBm; ``ref_loss_db`` is the loss at 1 distance unit).  A
:class:`CoverageMap` turns that into the two signals the runtime consumes:

- ``rate_factor(rss)`` in ``(0, 1]`` — the fraction of the station link's
  nominal bandwidth a client at that signal strength actually gets, linear
  in dB between the usable ``floor_dbm`` and ``full_dbm``.  The runtime
  prices a frame from a far client as ``size_bits / rate_factor`` on the
  *existing* netsim uplink queue, so path loss composes with whatever link
  model fronts the station (constant-rate, trace, Gilbert–Elliott fading)
  without a new link class.
- ``time_to_loss(trace, t, ...)`` — steps until a moving client's best
  signal drops below the floor, the probe the ``mobility_aware`` policy
  discounts reward by.

``station_fleet`` builds one :class:`~repro_torch.runtime.edge.EdgeWorker` per
station with a real netsim uplink *and* downlink, so offloaded frames pay
transit both ways.

Copied from the JAX package (``repro.mobility.coverage``): host numpy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.runtime.edge import EdgeLatencyModel, EdgeWorker

#: conventional "no signal" value (thermal noise floor territory)
NO_SIGNAL_DBM = -120.0


@dataclass(frozen=True)
class BaseStation:
    """One fixed edge placement with its radio parameters."""

    name: str
    x: float
    y: float
    tx_power_dbm: float = 30.0
    path_loss_exp: float = 2.7
    ref_loss_db: float = 40.0

    def rss_dbm(self, pos: np.ndarray) -> np.ndarray:
        """Received signal strength at ``pos`` (..., 2), in dBm."""
        p = np.asarray(pos, np.float64)
        d = np.sqrt((p[..., 0] - self.x) ** 2 + (p[..., 1] - self.y) ** 2)
        return (
            self.tx_power_dbm
            - self.ref_loss_db
            - 10.0 * self.path_loss_exp * np.log10(np.maximum(d, 1.0))
        )

    def spec(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "x": self.x,
            "y": self.y,
            "tx_power_dbm": self.tx_power_dbm,
            "path_loss_exp": self.path_loss_exp,
            "ref_loss_db": self.ref_loss_db,
        }


class CoverageMap:
    """The stations' joint footprint: per-position signal vector, best
    server, rate factors, and coverage-loss lookahead.

    Parameters
    ----------
    stations : sequence of BaseStation
    floor_dbm : float
        Usable floor — below this a client is out of coverage (offloads
        from here see ``min_rate_factor`` and should really stay local).
    full_dbm : float
        At or above this the client gets the link's full nominal rate.
    min_rate_factor : float
        Lower clamp on ``rate_factor`` so effective frame sizes stay
        finite (a frame from outside coverage is priced ruinously, not
        infinitely).
    """

    def __init__(
        self,
        stations: Sequence[BaseStation],
        *,
        floor_dbm: float = -82.0,
        full_dbm: float = -56.0,
        min_rate_factor: float = 0.05,
    ):
        if not stations:
            raise ValueError("coverage map needs at least one station")
        if full_dbm <= floor_dbm:
            raise ValueError(
                f"full_dbm must exceed floor_dbm, got {full_dbm} <= {floor_dbm}"
            )
        if not 0.0 < min_rate_factor <= 1.0:
            raise ValueError(f"min_rate_factor in (0, 1], got {min_rate_factor}")
        names = [s.name for s in stations]
        if len(set(names)) != len(names):
            raise ValueError(f"station names must be unique, got {names}")
        self.stations = list(stations)
        self.floor_dbm = float(floor_dbm)
        self.full_dbm = float(full_dbm)
        self.min_rate_factor = float(min_rate_factor)

    # ------------------------------------------------------------- signals

    def rss(self, pos: np.ndarray) -> np.ndarray:
        """Signal vector at ``pos``: shape (..., n_stations), dBm."""
        return np.stack([s.rss_dbm(pos) for s in self.stations], axis=-1)

    def best(self, pos: np.ndarray) -> Tuple[int, float]:
        """(station index, rss) of the strongest server at one position."""
        v = self.rss(pos)
        i = int(np.argmax(v))
        return i, float(v[i])

    def rate_factor(self, rss_dbm: float) -> float:
        """Fraction of nominal link rate at this signal strength — linear
        in dB between floor and full, clamped to [min_rate_factor, 1]."""
        frac = (float(rss_dbm) - self.floor_dbm) / (self.full_dbm - self.floor_dbm)
        return float(np.clip(frac, self.min_rate_factor, 1.0))

    def in_coverage(self, pos: np.ndarray) -> bool:
        return bool(self.rss(pos).max(axis=-1) >= self.floor_dbm)

    # ------------------------------------------------------------ lookahead

    def time_to_loss(
        self,
        trace: np.ndarray,
        t: int,
        *,
        dt: float = 1.0,
        horizon: int = 64,
        station: Optional[int] = None,
    ) -> float:
        """Time units until the client's signal (best-server by default, a
        fixed ``station`` when given) first drops below the floor, scanning
        the precomputed motion ``trace`` (T, 2) forward from step ``t``.
        ``inf`` when coverage holds through the horizon; ``0`` when already
        out.  A *prediction* in the paper's sense only in that the runtime
        owns the trace — clients don't see the future, the controller does
        (it generated the itinerary)."""
        end = min(len(trace), t + horizon + 1)
        seg = self.rss(trace[t:end])
        sig = seg[:, station] if station is not None else seg.max(axis=-1)
        below = np.flatnonzero(sig < self.floor_dbm)
        if below.size == 0:
            return float("inf")
        return float(below[0]) * float(dt)

    def spec(self) -> Dict[str, Any]:
        return {
            "stations": [s.spec() for s in self.stations],
            "floor_dbm": self.floor_dbm,
            "full_dbm": self.full_dbm,
            "min_rate_factor": self.min_rate_factor,
        }


def default_stations(
    n: int = 3, *, area: Tuple[float, float] = (1000.0, 1000.0), **radio: Any
) -> List[BaseStation]:
    """``n`` stations evenly spread along the area's horizontal midline —
    a corridor layout where straight-line motion crosses cell boundaries
    (the interesting case for handover)."""
    w, h = area
    return [
        BaseStation(f"bs{i}", x=w * (i + 0.5) / n, y=h / 2.0, **radio)
        for i in range(n)
    ]


def station_fleet(
    coverage: CoverageMap,
    *,
    capacity: int = 6,
    rate: Optional[float] = None,
    burst: float = 4.0,
    service: Optional[EdgeLatencyModel] = None,
    transmit_time: float = 0.25,
    queue_depth: int = 12,
    downlink_time: float = 0.05,
    downlink_depth: int = 32,
    seed: int = 0,
) -> List[EdgeWorker]:
    """One uplink- and downlink-fronted :class:`EdgeWorker` per station.

    Nominal rates: a full-signal frame transmits in ``transmit_time`` and
    its result returns in ``downlink_time`` (result payloads are small).
    Position-dependent quality enters at dispatch time via
    ``size_bits = frame_bits / rate_factor(rss)`` — the queues themselves
    are shared per-station radios, as in the real topology."""
    from repro_torch.netsim import ConstantRateLink

    svc = service if service is not None else EdgeLatencyModel(
        base=0.3, per_inflight=0.05, jitter=0.02
    )
    return [
        EdgeWorker(
            s.name,
            capacity=capacity,
            rate=rate,
            burst=burst,
            latency=svc,
            link=ConstantRateLink(1.0 / transmit_time),
            queue_depth=queue_depth,
            frame_bits=1.0,
            downlink=ConstantRateLink(1.0 / downlink_time),
            downlink_depth=downlink_depth,
            result_bits=1.0,
            seed=seed + i,
        )
        for i, s in enumerate(coverage.stations)
    ]
