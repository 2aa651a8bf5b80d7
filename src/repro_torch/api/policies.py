"""Decision-policy registry for the OffloadEngine.

Every policy is constructed from ``(calibration_scores, ratio)`` — the
calibration distribution of reward estimates the engine records at fit time —
and exposes the common contract:

    decide(estimate) -> bool          streaming, one item
    decide_batch(estimates) -> mask   a batch (token_bucket: in arrival order)
    set_ratio(ratio)                  runtime budget adjustment (Table I)

Registered: ``threshold`` (the paper's deployable quantile threshold),
``topk`` (exact per-batch top-k, the oracle-style evaluation policy), and
``token_bucket`` (hard rate constraint with burst tolerance, [23]-style).
Copied from the JAX package (``repro.api.policies``).  The netsim policies
(``queue_aware``, ``value_iteration`` — see :mod:`repro_torch.netsim.policy`),
the video policies (``temporal_hysteresis``, ``keyframe`` —
:mod:`repro_torch.video.policy`) and the online ``adaptive_threshold``
(:mod:`repro_torch.online.policy`), the fleet's ``fleet_fair``
(:mod:`repro_torch.fleet.budget`) and ``mobility_aware``
(:mod:`repro_torch.mobility.policy`) register themselves on first registry
access, so engine-built runtimes get them without importing those packages.

Policies that consume *runtime wiring* — injected zero-arg callables like
the simulation clock or a live congestion probe — declare the kwarg names
in a ``context_params`` class attribute.  Streaming sessions use it to
inject only what a policy accepts, and ``OffloadEngine.save`` uses it to
strip the callables from the serialized artifact.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Protocol, runtime_checkable

import numpy as np

from repro_torch.core.policy import ThresholdPolicy, TokenBucket
from repro_torch.core.reward import topk_offload_mask


@runtime_checkable
class Policy(Protocol):
    name: str
    #: True when ``decide_batch`` enforces an exact PER-BATCH budget (its
    #: decisions depend on how the stream is chunked).  Streaming consumers
    #: (``OffloadSession``) must fall back to per-item ``decide`` for such
    #: policies; buffer-invariant policies may leave the default False.
    batch_budget: bool = False
    #: constructor kwargs that are runtime-injected callables (clock,
    #: congestion probes, ...) — never serialized with the engine artifact.
    context_params: tuple = ()

    def decide(self, estimate: float) -> bool: ...

    def decide_batch(self, estimates: np.ndarray) -> np.ndarray: ...

    def set_ratio(self, ratio: float) -> None: ...

    def spec(self) -> Dict[str, Any]:
        """Extra constructor kwargs (beyond calibration_scores/ratio)."""
        ...


_POLICIES: Dict[str, Callable[..., Policy]] = {}


def register_policy(name: str):
    def deco(cls):
        cls.name = name
        _POLICIES[name] = cls
        return cls

    return deco


def _ensure_plugins() -> None:
    """Import the policy plugins that live outside ``repro_torch.api`` so
    registry lookups see them.  Lazy — called at lookup time, when this
    module is fully initialized — so there is no import cycle.  The same
    plugins as the JAX package's: netsim, video, online, fleet and
    mobility."""
    import repro_torch.fleet.budget  # noqa: F401  (registers on import)
    import repro_torch.mobility.policy  # noqa: F401
    import repro_torch.netsim.policy  # noqa: F401
    import repro_torch.online.policy  # noqa: F401
    import repro_torch.video.policy  # noqa: F401


def list_policies() -> List[str]:
    """Registered policy names (for runtime configs and error messages)."""
    _ensure_plugins()
    return sorted(_POLICIES)


def policy_context_params(name: str) -> tuple:
    """The runtime-injected (never serialized) constructor kwargs a policy
    declares — see ``Policy.context_params``."""
    _ensure_plugins()
    if name not in _POLICIES:
        raise KeyError(f"unknown policy {name!r}; have {list_policies()}")
    return tuple(getattr(_POLICIES[name], "context_params", ()))


def make_policy(
    name: str, calibration_scores: np.ndarray, ratio: float, **kwargs
) -> Policy:
    _ensure_plugins()
    if name not in _POLICIES:
        raise KeyError(f"unknown policy {name!r}; have {list_policies()}")
    return _POLICIES[name](calibration_scores, ratio, **kwargs)


def decide_sequential(policy: Policy, estimates: np.ndarray) -> np.ndarray:
    """``decide()`` each estimate in stream order — the ``decide_batch``
    body shared by stateful policies (token buckets, congestion trackers)
    whose decisions evolve item to item."""
    flat = np.asarray(estimates).ravel()
    return np.fromiter(
        (policy.decide(float(e)) for e in flat), dtype=bool, count=flat.size
    )


#: finite sentinels for the degenerate budgets (ratio 0 / 1), kept finite so
#: downstream arithmetic (Bellman backups, penalty subtraction) stays nan-free
NEVER_THRESHOLD = 1e9
ALWAYS_THRESHOLD = -1e9


def quantile_threshold(calibration_scores: np.ndarray, ratio: float) -> float:
    """The (1 - ratio)-quantile of the calibration distribution — the
    threshold every quantile-budget policy (api, netsim, video) derives its
    decision rule from — with finite sentinels at the degenerate budgets."""
    cal = np.asarray(calibration_scores, np.float64)
    r = float(np.clip(ratio, 0.0, 1.0))
    if cal.size == 0 or r >= 1.0:
        return ALWAYS_THRESHOLD
    if r <= 0.0:
        return NEVER_THRESHOLD
    return float(np.quantile(cal, 1.0 - r))


class BudgetTracker:
    """Integral controller on the realized offload ratio, shared by the
    stateful stream policies (netsim ``queue_aware``, the video temporal
    policies): with ``deficit`` the running shortfall in frames
    (``ratio * decided - offloaded``), the effective budget is
    ``ratio + gain * deficit`` clipped to [0, 1].  Because the deficit
    accumulates, any persistent suppression — congestion, stale-result
    credit — is eventually paid back and the realized ratio converges to
    the target.  The target's own degenerate budgets stay hard caps: the
    controller may not push a ratio-0 stream into offloading."""

    def __init__(self, gain: float):
        self.gain = float(gain)
        self._decided = 0
        self._offloaded = 0

    def threshold(self, sorted_calibration: np.ndarray, ratio: float) -> float:
        if ratio <= 0.0:
            return NEVER_THRESHOLD
        if ratio >= 1.0:
            return ALWAYS_THRESHOLD
        deficit = ratio * self._decided - self._offloaded
        r_adj = float(np.clip(ratio + self.gain * deficit, 0.0, 1.0))
        return quantile_threshold(sorted_calibration, r_adj)

    def account(self, offload: bool) -> None:
        self._decided += 1
        self._offloaded += int(offload)


@register_policy("threshold")
class QuantileThresholdPolicy:
    """Offload iff estimate > T, T = (1-r)-quantile of calibration scores."""

    def __init__(self, calibration_scores: np.ndarray, ratio: float):
        self._inner = ThresholdPolicy(calibration_scores, ratio)

    @property
    def ratio(self) -> float:
        return self._inner.ratio

    @property
    def threshold(self) -> float:
        return self._inner.threshold

    def set_ratio(self, ratio: float) -> None:
        self._inner.set_ratio(ratio)

    def decide(self, estimate: float) -> bool:
        return self._inner.decide(estimate)

    def decide_batch(self, estimates: np.ndarray) -> np.ndarray:
        return self._inner.decide_batch(estimates)

    def spec(self) -> Dict[str, Any]:
        return {}


@register_policy("topk")
class TopKPolicy:
    """Exact per-batch budget: offload the top ``ratio`` fraction of the
    batch (ties resolved stably by position).  Single-item ``decide`` falls
    back to the calibration quantile threshold."""

    batch_budget = True  # decide_batch depends on the chunking of the stream

    def __init__(self, calibration_scores: np.ndarray, ratio: float):
        self._threshold = ThresholdPolicy(calibration_scores, ratio)
        self.ratio = self._threshold.ratio

    def set_ratio(self, ratio: float) -> None:
        self._threshold.set_ratio(ratio)
        self.ratio = self._threshold.ratio

    def decide(self, estimate: float) -> bool:
        return self._threshold.decide(estimate)

    def decide_batch(self, estimates: np.ndarray) -> np.ndarray:
        return topk_offload_mask(np.asarray(estimates, np.float64), self.ratio)

    def spec(self) -> Dict[str, Any]:
        return {}


@register_policy("token_bucket")
class TokenBucketPolicy:
    """Hard offload-rate constraint with burst tolerance ``depth``; the rate
    is the target ratio and the base threshold its calibration quantile.

    ``clock`` (optional, not serialized) switches the bucket to time-based
    refill — see :class:`repro_torch.core.policy.TokenBucket`; streaming sessions
    inject their simulation clock here.
    """

    context_params = ("clock",)

    def __init__(
        self,
        calibration_scores: np.ndarray,
        ratio: float,
        depth: float = 8.0,
        clock: Optional[Callable[[], float]] = None,
    ):
        self._cal = np.sort(np.asarray(calibration_scores, dtype=np.float64))
        self.depth = float(depth)
        self.clock = clock
        self.set_ratio(ratio)

    def set_ratio(self, ratio: float) -> None:
        self.ratio = float(np.clip(ratio, 0.0, 1.0))
        # finite sentinels at the edges: the bucket's scarcity interpolation
        # thr = base + (1-base)*scarcity is nan-free only for finite base
        if self._cal.size == 0 or self.ratio >= 1.0:
            base = -1e30
        elif self.ratio <= 0.0:
            base = 1e30
        else:
            base = float(np.quantile(self._cal, 1.0 - self.ratio))
        # a re-budget must not refill the bucket — carrying the level over
        # keeps the hard rate constraint across runtime ratio changes
        prev = getattr(self, "bucket", None)
        level = min(prev.level, self.depth) if prev is not None else None
        self.bucket = TokenBucket(
            rate=self.ratio, depth=self.depth, base_threshold=base, level=level,
            clock=self.clock,
        )

    def decide(self, estimate: float) -> bool:
        return self.bucket.decide(float(estimate))

    def decide_batch(self, estimates: np.ndarray) -> np.ndarray:
        # sequential by construction: estimates arrive in stream order
        return decide_sequential(self, estimates)

    def spec(self) -> Dict[str, Any]:
        return {"depth": self.depth}
