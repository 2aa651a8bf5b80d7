"""The city-scale headline experiment: coordinated budget redistribution
vs static equal-split at equal total offload budget.

Scenario: ``n_streams`` camera streams partitioned into ``n_shards`` city
districts, each district's weak detector operating at a different
**hardness** — how much accuracy an offload to the strong model recovers.
An easy district's frames gain almost nothing from offloading; a hard
district's frames gain a lot.  Every frame's weak output leaks its own
difficulty into the feature vector (the paper's deployability constraint:
the estimator sees only the weak result), so the engine's reward scores
carry the district-level signal.

Both arms run the identical :class:`~repro_torch.fleet.budget.FleetBudget`
token-bucket mechanics at the same global rate — the *only* difference is
``redistribute_every``: the coordinated arm periodically moves bucket
shares toward districts whose realized offloads score higher, the static
arm keeps the equal split.  The per-shard ``fleet_fair`` integral
controllers pin each arm's realized ratio to the same fleet target, so the
comparison is equal-budget by construction.  Effective accuracy is
per-frame: the strong detector's AP where the frame was actually served by
an edge, the weak detector's AP otherwise.

The headline claim — asserted by ``tests/test_fleet.py`` — is that the
coordinated arm's mean effective accuracy strictly exceeds the static
arm's at (approximately) equal total realized offload ratio.

The port of ``repro.fleet.experiment``: the same numpy draws, the engine
fitted on ``device`` (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.api.engine import OffloadEngine
from repro_torch.fleet.plane import FleetPlane
from repro_torch.fleet.runtime import FleetTrace, simulate_fleet
from repro_torch.kernels.dispatch import DeviceLike
from repro_torch.runtime.edge import EdgeLatencyModel, EdgeWorker

#: per-district hardness: max AP a strong-model offload recovers on the
#: district's frames (scaled by the frame's latent difficulty)
DEFAULT_HARDNESS: Tuple[float, ...] = (0.05, 0.25, 0.6, 1.0)

#: AP both detectors agree on for a trivially easy frame
BASE_AP = 0.9
#: reward scale: full-hardness, full-difficulty frames gain this much AP
REWARD_SCALE = 0.4


def _district_frames(
    rng: np.random.Generator, n: int, hardness: float, noise: float, n_features: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(features (n, F), rewards (n,)) for one district's frames.  The
    latent difficulty ``u`` and the district hardness leak into the first
    feature columns through weak-output-style noisy proxies; the rest is
    distractor noise."""
    u = rng.uniform(0.0, 1.0, n)
    r = REWARD_SCALE * hardness * u
    x = rng.normal(0.0, 1.0, (n, n_features)).astype(np.float32)
    eps = rng.normal(0.0, noise, (3, n))
    x[:, 0] = 1.0 - r + eps[0]  # weak mean-confidence proxy
    x[:, 1] = u + eps[1]  # clutter / box-count proxy
    x[:, 2] = hardness + eps[2]  # district appearance statistics
    return x, r


@dataclass
class CityScenario:
    """A fully seeded city workload: fitted engine, tick-major features,
    and precomputed per-frame weak/strong APs.  Stream ``s`` belongs to
    district ``s * n_shards // n_streams`` (contiguous blocks, matching
    :class:`~repro_torch.fleet.runtime.FleetRuntime`'s partition)."""

    engine: OffloadEngine
    features: np.ndarray  # (T, S, F)
    weak_ap: np.ndarray  # (T, S)
    strong_ap: np.ndarray  # (T, S)
    hardness: Tuple[float, ...]
    seed: int = 0

    @property
    def n_ticks(self) -> int:
        return self.weak_ap.shape[0]

    @property
    def n_streams(self) -> int:
        return self.weak_ap.shape[1]

    @property
    def n_shards(self) -> int:
        return len(self.hardness)

    @property
    def rewards(self) -> np.ndarray:
        """(T, S) realized offload reward: strong − weak per-frame AP."""
        return self.strong_ap - self.weak_ap

    def fleet_factory(self, shard: int) -> List[EdgeWorker]:
        """A generous per-district fleet behind *real* netsim uplinks: a
        seeded Gilbert–Elliott fading channel per edge, provisioned so the
        whole district's budgeted offload rate transmits in a fraction of a
        tick even through a fade — admission still almost never refuses,
        so the experiment keeps isolating *decision* quality (the budget is
        the binding constraint) while every offload now pays and reports
        genuine per-frame transit."""
        from repro_torch.netsim import GilbertElliottLink

        per = -(-self.n_streams // self.n_shards)
        bandwidth = 8.0 * max(per, 4)  # frames per tick at full signal
        return [
            EdgeWorker(
                f"s{shard}e{i}",
                capacity=max(per, 4),
                latency=EdgeLatencyModel(base=1.0, jitter=0.05),
                link=GilbertElliottLink(
                    bandwidth=bandwidth,
                    bad_bandwidth=bandwidth / 4.0,
                    p_gb=0.05,
                    p_bg=0.4,
                    slot=1.0,
                    seed=self.seed * 131 + 7 * shard + i,
                ),
                queue_depth=2 * max(per, 4),
                frame_bits=1.0,
                seed=self.seed + 7 * shard + i,
            )
            for i in range(2)
        ]


def default_city_scenario(
    n_streams: int = 1024,
    n_ticks: int = 48,
    *,
    hardness: Tuple[float, ...] = DEFAULT_HARDNESS,
    seed: int = 0,
    noise: float = 0.05,
    n_features: int = 12,
    calibration_frames: int = 4096,
    estimator_epochs: int = 40,
    device: DeviceLike = "cuda",
) -> CityScenario:
    """Build the seeded headline scenario.  The engine is fitted the
    paper's way on a held-out mixed-district calibration set (true rewards,
    rank-transformed), on ``device``, then serves the city frozen."""
    from repro_torch.api.reward_model import MLPRewardModel
    from repro_torch.core.estimator import EstimatorConfig

    n_shards = len(hardness)
    if n_streams % n_shards:
        raise ValueError(
            f"n_streams={n_streams} must divide into {n_shards} districts"
        )
    per = n_streams // n_shards

    # ---- calibration on the same district mixture (held-out seed)
    cal_rng = np.random.default_rng(seed + 101)
    cal_x, cal_r = zip(*(
        _district_frames(
            cal_rng, calibration_frames // n_shards, h, noise, n_features
        )
        for h in hardness
    ))
    engine = OffloadEngine(
        reward_model=MLPRewardModel(
            config=EstimatorConfig(
                hidden=(32,), epochs=estimator_epochs, batch_size=128, seed=seed
            ),
            device=device,
        ),
        policy="threshold",
        ratio=0.25,
    )
    engine.fit(features=np.concatenate(cal_x), rewards=np.concatenate(cal_r))

    # ---- the served city, tick-major
    rng = np.random.default_rng(seed)
    features = np.zeros((n_ticks, n_streams, n_features), np.float32)
    rewards = np.zeros((n_ticks, n_streams))
    for k, h in enumerate(hardness):
        sl = slice(k * per, (k + 1) * per)
        x, r = _district_frames(rng, n_ticks * per, h, noise, n_features)
        features[:, sl] = x.reshape(n_ticks, per, n_features)
        rewards[:, sl] = r.reshape(n_ticks, per)
    weak_ap = BASE_AP - rewards
    strong_ap = np.full_like(weak_ap, BASE_AP)
    return CityScenario(
        engine=engine,
        features=features,
        weak_ap=weak_ap,
        strong_ap=strong_ap,
        hardness=tuple(float(h) for h in hardness),
        seed=seed,
    )


@dataclass
class CityRunResult:
    """One arm's full trajectory over the city scenario."""

    effective: np.ndarray  # (T, S) per-frame effective accuracy
    decision: np.ndarray  # (T, S) policy decisions (budget spent)
    served: np.ndarray  # (T, S) frames actually answered by an edge
    trace: FleetTrace

    def realized_ratio(self) -> float:
        return float(np.mean(self.decision))

    def mean_effective(self) -> float:
        return float(np.mean(self.effective))

    def shard_ratios(self) -> Tuple[float, ...]:
        return self.trace.telemetry.shard_ratios

    def summary(self) -> Dict[str, Any]:
        return {
            "realized_ratio": self.realized_ratio(),
            "served_ratio": float(np.mean(self.served)),
            "mean_effective": self.mean_effective(),
            "shard_ratios": list(self.shard_ratios()),
            "shard_shares": list(self.trace.telemetry.shard_shares),
            "redistributions": self.trace.telemetry.budget_redistributions,
        }


def run_city_scenario(
    scenario: CityScenario,
    *,
    coordinated: bool,
    ratio: float = 0.25,
    redistribute_every: float = 8.0,
    min_share: float = 0.25,
    smooth: float = 0.5,
    plane: Optional[FleetPlane] = None,
    seed: Optional[int] = None,
) -> CityRunResult:
    """Serve the city end to end with one arm.  Arms differ only in
    whether the shared budget redistributes; everything else — scenario,
    engine, fleets, clock, seeds — is identical."""
    trace = simulate_fleet(
        scenario.engine,
        scenario.features,
        n_shards=scenario.n_shards,
        plane=plane,
        ratio=ratio,
        redistribute_every=redistribute_every if coordinated else None,
        min_share=min_share,
        smooth=smooth,
        fleet_factory=scenario.fleet_factory,
        seed=scenario.seed if seed is None else seed,
    )
    served = trace.offload_mask()
    return CityRunResult(
        effective=np.where(served, scenario.strong_ap, scenario.weak_ap),
        decision=trace.decision_mask(),
        served=served,
        trace=trace,
    )
