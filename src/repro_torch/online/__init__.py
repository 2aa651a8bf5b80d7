"""Closed-loop adaptation over the frozen offloading engine — the port of
``repro.online``.

The paper fits its reward estimator once and freezes it — but in deployment
every offloaded frame returns the strong detection, a free supervision
signal.  This subsystem closes the loop on the existing engine seams:

- :mod:`repro_torch.online.updates` — streaming reward-model refit from
  realized strong−weak per-frame AP: an incremental last-layer
  least-squares path on the fused estimator MLP and a periodic mini-refit
  (autograd + the port's AdamW on the engine's device), over a replay ring
  buffer of feature blocks.
- :mod:`repro_torch.online.cdf` — P²-style streaming quantile tracking
  keeping the score calibration and the MORIC rank transform live as
  distributions move (round-trips through ``CdfTransform.state()/from_state``).
- :mod:`repro_torch.online.drift` — realized-vs-predicted residual
  CUSUM/EWMA drift detection that widens the offload ratio and forces
  refits when estimator confidence decays.
- :mod:`repro_torch.online.netstate` — measured rolling RTT / bandwidth /
  queue-sojourn estimators fed from completed round trips, replacing the
  oracle ``congestion``/``state_probe`` context probes
  (``OffloadRuntime(net_state=...)``).
- :mod:`repro_torch.online.engine` — :class:`AdaptiveEngine`, the wrapper
  tying them together with explicit ``observe()``/``maybe_update()`` hooks
  on the manual clock; fully seeded, checkpointable (``repro``'s layout),
  bit-identical on replay.
- :mod:`repro_torch.online.experiment` — the seeded mid-stream
  distribution-shift headline: the adaptive engine recovers post-shift
  effective accuracy the frozen engine permanently loses, at equal realized
  offload ratio.

The ``adaptive_threshold`` policy registers through the same lazy registry
hook as the netsim/video policies.
"""
from repro_torch.online.cdf import StreamingQuantiles
from repro_torch.online.drift import DriftConfig, DriftDetector
from repro_torch.online.engine import (
    AdaptiveEngine,
    OnlineConfig,
    UpdateReport,
    clone_engine,
)
from repro_torch.online.experiment import (
    POST_SHIFT_PROFILE,
    PRE_SHIFT_PROFILE,
    ShiftRunResult,
    ShiftScenario,
    default_shift_scenario,
    run_shift_scenario,
)
from repro_torch.online.netstate import NetworkEstimator
from repro_torch.online.policy import AdaptiveThresholdPolicy
from repro_torch.online.updates import (
    LastLayerSolver,
    ReplayBuffer,
    apply_last_layer,
    hidden_features,
    mini_refit,
    reward_to_logit,
)

__all__ = [
    "AdaptiveEngine",
    "AdaptiveThresholdPolicy",
    "DriftConfig",
    "DriftDetector",
    "LastLayerSolver",
    "NetworkEstimator",
    "OnlineConfig",
    "POST_SHIFT_PROFILE",
    "PRE_SHIFT_PROFILE",
    "ReplayBuffer",
    "ShiftRunResult",
    "ShiftScenario",
    "StreamingQuantiles",
    "UpdateReport",
    "apply_last_layer",
    "clone_engine",
    "default_shift_scenario",
    "hidden_features",
    "mini_refit",
    "reward_to_logit",
    "run_shift_scenario",
]
