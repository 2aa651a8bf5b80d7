"""`AdaptiveEngine` — closed-loop adaptation over a fitted `OffloadEngine`.

The wrapper owns the four online components and the cadence that ties them
together on the runtime's manual clock:

- every completed offload is fed back via :meth:`observe` (features,
  predicted estimate, realized strong−weak reward) into the replay ring
  buffer, the streaming reward-CDF tracker, and the drift detector;
- every scored frame's estimate feeds :meth:`observe_estimate` into the
  streaming score-quantile tracker (so ``set_ratio`` thresholds stay
  calibrated as the score distribution moves);
- :meth:`maybe_update` runs the cadence: an incremental last-layer solve
  every ``update_every`` observations, a mini-refit every
  ``refit_every`` (or immediately when the drift detector fires), followed
  by a transform/calibration refresh and a policy rebuild.

All model mutation is **in place** on the wrapped engine's estimator
params, so every session scoring through the shared engine sees updates at
its next micro-batch flush — no session rewiring.  Nothing here reads a
wall clock or an unseeded RNG: given the same observation sequence the
update trajectory is bit-identical, and :meth:`save`/:meth:`load` extend
the engine's own artifact with the full online state (ring buffer +
cursor, quantile markers, drift statistics, counters) so a restored run
replays exactly.  Runtime probe callables are never serialized — the
engine's artifact already strips policy ``context_params``, and the
adaptive layer holds none of its own.

The port of ``repro.online.engine``: the model updates run on the wrapped
engine's device (:mod:`repro_torch.online.updates`), everything else is host
numpy, and checkpoints are ``repro``'s ``save_flat`` layout, so either
package loads the other's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.api.engine import OffloadEngine
from repro_torch.api.policies import make_policy
from repro_torch.api.reward_model import MLPRewardModel
from repro_torch.kernels.dispatch import DeviceLike
from repro_torch.online.cdf import StreamingQuantiles
from repro_torch.online.drift import DriftConfig, DriftDetector
from repro_torch.online.updates import (
    LastLayerSolver,
    ReplayBuffer,
    apply_last_layer,
    hidden_features,
    mini_refit,
    reward_to_logit,
)
from repro_torch.train.checkpoint import load_flat, save_flat

_ADAPTIVE_KIND = "adaptive_engine"


@dataclass(frozen=True)
class OnlineConfig:
    """Cadence and strength of the closed loop."""

    buffer_capacity: int = 512  # replay ring size (observations)
    min_observations: int = 32  # warmup before any model update
    update_every: int = 8  # observations between last-layer solves
    refit_every: int = 128  # observations between mini-refits
    refit_epochs: int = 8
    refit_lr: float = 5e-4
    refit_batch_size: int = 128
    l2: float = 1e-2  # last-layer ridge strength
    forget: float = 0.98  # solver forgetting per ingested block
    n_markers: int = 65  # quantile-tracker resolution
    update_transform: bool = True  # refresh the reward CDF from the stream
    recalibrate: bool = True  # refresh calibration scores + policy
    seed: int = 0  # mini-refit shuffle seed
    drift: DriftConfig = field(default_factory=DriftConfig)

    def as_meta(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["drift"] = dataclasses.asdict(self.drift)
        return d

    @classmethod
    def from_meta(cls, meta: Dict[str, Any]) -> "OnlineConfig":
        kw = dict(meta)
        kw["drift"] = DriftConfig(**kw["drift"])
        return cls(**kw)


@dataclass(frozen=True)
class UpdateReport:
    """What one ``maybe_update`` call did."""

    incremental: bool = False  # last-layer solve applied
    refit: bool = False  # mini-refit applied
    drift: bool = False  # the refit was drift-forced
    recalibrated: bool = False  # transform/calibration/policy refreshed
    ratio_scale: float = 1.0  # drift-widened offload-ratio multiplier

    @property
    def changed(self) -> bool:
        return self.incremental or self.refit


class AdaptiveEngine:
    """Closed-loop wrapper around a fitted :class:`OffloadEngine`.

    Scoring/deciding delegate to the wrapped engine (sessions keep working
    against ``adaptive.engine`` unchanged); the wrapper adds the feedback
    path.  The incremental path requires the deployable fused MLP shape
    (single hidden layer + sigmoid head); other reward models fall back to
    mini-refits only.
    """

    def __init__(
        self,
        engine: OffloadEngine,
        config: Optional[OnlineConfig] = None,
        *,
        obs: Optional[Any] = None,
    ):
        if engine.calibration_scores is None:
            raise RuntimeError("AdaptiveEngine wraps a *fitted* engine")
        self.engine = engine
        self.config = config if config is not None else OnlineConfig()
        feature_dim = self._feature_dim()
        self.buffer = ReplayBuffer(self.config.buffer_capacity, feature_dim)
        self.score_tracker = StreamingQuantiles(self.config.n_markers).warm_start(
            np.asarray(engine.calibration_scores)
        )
        self.reward_tracker: Optional[StreamingQuantiles] = (
            StreamingQuantiles.from_transform(engine.transform, self.config.n_markers)
            if engine.transform is not None
            else None
        )
        self.drift = DriftDetector(self.config.drift)
        self.solver: Optional[LastLayerSolver] = (
            LastLayerSolver(
                self._hidden_dim(), l2=self.config.l2, forget=self.config.forget
            )
            if self._incremental_capable()
            else None
        )
        self.base_ratio = float(engine.ratio)
        self.observations = 0
        self.incremental_updates = 0
        self.refits = 0
        self.drift_events = 0
        self._since_update = 0
        self._since_refit = 0
        self._unsolved_lo = 0  # buffer offset of rows not yet ingested
        # observability: update counters by kind, the live drift ratio
        # multiplier as a callback gauge, and one traced span per applied
        # update (stamped from whatever clock the obs handle is bound to)
        self._profiler = obs.profiler if obs is not None else None
        self._tracer = obs.tracer if obs is not None else None
        self._update_counters: Optional[Dict[str, Any]] = None
        reg = obs.metrics if obs is not None else None
        if reg is not None:
            self._update_counters = {
                kind: reg.counter(
                    "repro_adaptive_updates_total", {"kind": kind},
                    help="closed-loop model updates applied, by kind",
                )
                for kind in ("incremental", "refit", "drift")
            }
            reg.gauge(
                "repro_adaptive_ratio_scale",
                help="drift-gated offload ratio multiplier",
                fn=self.drift.ratio_multiplier,
            )
            reg.gauge(
                "repro_adaptive_observations",
                help="realized rewards observed so far",
                fn=lambda: self.observations,
            )

    # ------------------------------------------------------------- plumbing

    def _feature_dim(self) -> int:
        model = self.engine.reward_model
        in_dim = getattr(model, "in_dim", None)
        if in_dim is None:
            raise ValueError("adaptive updates need a feature-vector reward model")
        return int(in_dim)

    def _incremental_capable(self) -> bool:
        model = self.engine.reward_model
        return isinstance(model, MLPRewardModel) and len(model.config.hidden) == 1

    def _hidden_dim(self) -> int:
        return int(self.engine.reward_model.config.hidden[0])

    def _transform_rewards(self, rewards: np.ndarray) -> np.ndarray:
        """Raw realized rewards -> the rank space the model regresses."""
        r = np.asarray(rewards, np.float64)
        if self.engine.transform is not None:
            return np.asarray(self.engine.transform(r), np.float64)
        return r

    # ------------------------------------------------------------- feedback

    def observe(
        self,
        features: np.ndarray,
        estimates: np.ndarray,
        rewards: np.ndarray,
    ) -> None:
        """Feed back one block of completed offloads: the features the
        session scored, the estimates the policy acted on, and the realized
        strong−weak rewards (raw scale, as ``fit`` received them)."""
        x = np.asarray(features, np.float32)
        if x.ndim == 1:
            x = x[None, :]
        est = np.atleast_1d(np.asarray(estimates, np.float64))
        raw = np.atleast_1d(np.asarray(rewards, np.float64))
        if not (x.shape[0] == est.shape[0] == raw.shape[0]):
            raise ValueError(
                f"block mismatch: {x.shape[0]} features, {est.shape[0]} estimates, "
                f"{raw.shape[0]} rewards"
            )
        self.buffer.append(x, raw)
        targets = self._transform_rewards(raw)
        for e, y, r in zip(est, targets, raw):
            self.drift.update(predicted=float(e), realized=float(y))
            if self.reward_tracker is not None:
                self.reward_tracker.update(float(r))
        self.observations += x.shape[0]
        self._since_update += x.shape[0]
        self._since_refit += x.shape[0]

    def observe_estimate(self, estimate: float) -> None:
        """Track one scored estimate (offloaded or not) so the live score
        distribution — and therefore ``set_ratio`` quantiles — follows the
        stream."""
        self.score_tracker.update(float(estimate))

    def observe_estimates(self, estimates: np.ndarray) -> None:
        self.score_tracker.update_batch(np.asarray(estimates, np.float64))

    # -------------------------------------------------------------- updates

    def _recent_block(self):
        """Buffer rows appended since the last solver ingestion."""
        x, y = self.buffer.data()
        n_total = self.buffer.count
        lo = max(self._unsolved_lo, n_total - len(x))
        take = n_total - lo
        if take <= 0:
            return None
        return x[-take:], y[-take:]

    def _incremental_update(self) -> bool:
        if self.solver is None:
            return False
        block = self._recent_block()
        if block is None:
            return False
        x, raw = block
        model = self.engine.reward_model
        h = hidden_features(model, x)
        y_logit = reward_to_logit(self._transform_rewards(raw))
        self.solver.ingest(h, y_logit)
        w, b = self.solver.solve()
        apply_last_layer(model, w, b)
        self._unsolved_lo = self.buffer.count
        self.incremental_updates += 1
        return True

    def _full_refit(self) -> bool:
        x, raw = self.buffer.data()
        if x.shape[0] == 0:
            return False
        y = np.asarray(self._transform_rewards(raw), np.float32)
        mini_refit(
            self.engine.reward_model,
            x,
            y,
            epochs=self.config.refit_epochs,
            lr=self.config.refit_lr,
            batch_size=self.config.refit_batch_size,
            seed=self.config.seed + self.refits,
        )
        if self.solver is not None:
            # the hidden layer moved: the accumulated design matrix no
            # longer describes it, so evidence restarts from this refit
            self.solver.reset()
        self._unsolved_lo = self.buffer.count
        self.refits += 1
        return True

    def _refresh_calibration(self) -> bool:
        """Push the live distributions back into the engine: reward CDF from
        the reward tracker, calibration scores from the streaming score
        tracker (it sees *every* scored frame — the replay buffer only holds
        the offloaded, high-estimate tail and would bias the quantiles), and
        a rebuilt policy."""
        eng = self.engine
        if self.config.update_transform and self.reward_tracker is not None:
            eng.transform = self.reward_tracker.to_transform()
        if not self.config.recalibrate:
            return False
        eng.calibration_scores = self.score_tracker.calibration_scores()
        live_ratio = float(getattr(eng.policy, "ratio", eng.ratio))
        eng.policy = make_policy(
            eng.policy_name, eng.calibration_scores, live_ratio, **eng.policy_kwargs
        )
        return True

    def maybe_update(self, now: Optional[float] = None) -> UpdateReport:
        """Run the update cadence; call once per arrival step (cheap when
        nothing is due).  ``now`` is accepted for symmetry with the manual
        clock but cadence is observation-counted, not time-counted."""
        del now
        if self.observations < self.config.min_observations:
            return UpdateReport(ratio_scale=self.drift.ratio_multiplier())
        drift_forced = self.drift.drifted
        refit = False
        incremental = False
        prof = self._profiler
        if drift_forced or self._since_refit >= self.config.refit_every:
            t0 = prof.begin() if prof is not None else 0.0
            refit = self._full_refit()
            if prof is not None:
                prof.add("online.refit", t0)
            if refit:
                self._since_refit = 0
                self._since_update = 0
                if drift_forced:
                    self.drift.reset()
                    self.drift_events += 1
                else:
                    self.drift.reset(count_event=False)
        elif self._since_update >= self.config.update_every:
            t0 = prof.begin() if prof is not None else 0.0
            incremental = self._incremental_update()
            if prof is not None:
                prof.add("online.incremental", t0)
            if incremental:
                self._since_update = 0
                # the model just moved under the detector's feet — re-anchor
                # so the loop's own updates don't register as drift
                self.drift.rebaseline()
        recalibrated = False
        if refit or incremental:
            recalibrated = self._refresh_calibration()
            if self._update_counters is not None:
                if refit:
                    self._update_counters["refit"].inc()
                    if drift_forced:
                        self._update_counters["drift"].inc()
                else:
                    self._update_counters["incremental"].inc()
            if self._tracer is not None:
                t = self._tracer.clock()
                self._tracer.instant(
                    "online.update", t=t,
                    args={
                        "kind": "refit" if refit else "incremental",
                        "drift": bool(drift_forced and refit),
                        "recalibrated": bool(recalibrated),
                    },
                )
        return UpdateReport(
            incremental=incremental,
            refit=refit,
            drift=drift_forced and refit,
            recalibrated=recalibrated,
            ratio_scale=self.drift.ratio_multiplier(),
        )

    # ------------------------------------------------------------ delegation

    def score(self, weak_outputs: Any = None, **kw) -> np.ndarray:
        return self.engine.score(weak_outputs, **kw)

    def decide(self, weak_outputs: Any = None, **kw):
        return self.engine.decide(weak_outputs, **kw)

    def features(self, weak_outputs: Any = None, **kw) -> np.ndarray:
        return self.engine.features(weak_outputs, **kw)

    def set_ratio(self, ratio: float) -> None:
        self.base_ratio = float(ratio)
        self.engine.set_ratio(ratio)

    # ------------------------------------------------------------ save/load

    def save(self, path: str) -> None:
        """One artifact: the wrapped engine's checkpoint plus the full
        online state.  Runtime probes are stripped exactly as the engine
        strips policy ``context_params``."""
        arrays, meta = self.engine.artifact_state()
        arrays["online"] = {
            "buffer": self.buffer.state(),
            "score_tracker": self.score_tracker.state(),
            "drift": self.drift.state(),
            "counters": np.asarray(
                [
                    self.observations,
                    self.incremental_updates,
                    self.refits,
                    self.drift_events,
                    self._since_update,
                    self._since_refit,
                    self._unsolved_lo,
                ],
                np.int64,
            ),
        }
        if self.reward_tracker is not None:
            arrays["online"]["reward_tracker"] = self.reward_tracker.state()
        if self.solver is not None:
            arrays["online"]["solver"] = self.solver.state()
        meta["kind"] = _ADAPTIVE_KIND
        meta["online"] = {
            "config": self.config.as_meta(),
            "base_ratio": self.base_ratio,
            "engine_kind": "offload_engine",
        }
        save_flat(path, arrays, meta)

    @classmethod
    def load(cls, path: str, *, device: DeviceLike = "cuda") -> "AdaptiveEngine":
        """Restore a checkpoint (either package's) with the engine on
        ``device``."""
        arrays, meta = load_flat(path)
        if meta is None or meta.get("kind") != _ADAPTIVE_KIND:
            raise ValueError(f"{path} is not an AdaptiveEngine checkpoint")
        engine_meta = dict(meta)
        engine_meta["kind"] = engine_meta["online"]["engine_kind"]
        engine = OffloadEngine.from_artifact_state(arrays, engine_meta, device=device)
        config = OnlineConfig.from_meta(meta["online"]["config"])
        adaptive = cls(engine, config)
        online = arrays["online"]
        adaptive.buffer = ReplayBuffer.from_state(online["buffer"])
        adaptive.score_tracker = StreamingQuantiles.from_state(online["score_tracker"])
        adaptive.drift = DriftDetector.from_state(online["drift"], config.drift)
        if "reward_tracker" in online:
            adaptive.reward_tracker = StreamingQuantiles.from_state(
                online["reward_tracker"]
            )
        if "solver" in online and adaptive.solver is not None:
            adaptive.solver = LastLayerSolver.from_state(
                online["solver"], l2=config.l2, forget=config.forget
            )
        c = np.asarray(online["counters"], np.int64)
        (
            adaptive.observations,
            adaptive.incremental_updates,
            adaptive.refits,
            adaptive.drift_events,
            adaptive._since_update,
            adaptive._since_refit,
            adaptive._unsolved_lo,
        ) = (int(v) for v in c)
        adaptive.base_ratio = float(meta["online"]["base_ratio"])
        return adaptive


def clone_engine(engine: OffloadEngine) -> OffloadEngine:
    """A deep, independent copy of a fitted engine via its own artifact
    round-trip (in memory, no disk) on the engine's device — adaptive runs
    mutate model params in place, so experiments clone before adapting to
    keep the frozen arm pristine."""
    import copy

    arrays, meta = engine.artifact_state()
    return OffloadEngine.from_artifact_state(
        copy.deepcopy(arrays), copy.deepcopy(meta), device=engine.device
    )
