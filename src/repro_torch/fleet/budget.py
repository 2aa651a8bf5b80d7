"""Fleet-wide offload-budget coordination.

The paper's budget is per-device; a city deployment shares one rate-limited
edge tier across many shards (Qiu et al. make the shared-rate constraint
explicit).  :class:`FleetBudget` holds one *global* token rate split into
per-shard :class:`~repro_torch.core.policy.TokenBucket`\\ s on the shared manual
clock, and periodically **redistributes** the split toward shards whose
realized offloads carry higher engine reward scores — the global rate is
conserved exactly, only its division moves.  ``redistribute_every=None``
freezes the equal split, so the static arm of the city experiment runs the
*identical* token-bucket mechanics and the comparison is equal-budget by
construction.

``fleet_fair`` is the per-shard decision policy over a coordinated budget:
a quantile threshold on the shard's *allocated* ratio (its share of the
global budget, integral-tracked so the realized shard ratio converges to
the allocation), gated by the shard's token bucket.  It registers through
the lazy ``_ensure_plugins`` hook like the netsim/video/online policies;
``budget``/``shard``/``clock`` are runtime wiring (``context_params``),
never serialized with the engine artifact.

Copied from the JAX package (``repro.fleet.budget``): host numpy, with
``fleet_fair`` registered through ``_ensure_plugins``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.api.policies import (
    BudgetTracker,
    decide_sequential,
    register_policy,
)
from repro_torch.core.policy import TokenBucket


class FleetBudget:
    """A global token-bucket offload budget split across ``n_shards``.

    Parameters
    ----------
    total_rate : float
        Fleet-wide token arrivals per time unit (one offload = one token).
        Conserved across redistributions: ``sum(shard rates) == total_rate``.
    n_shards : int
        Number of shards sharing the budget.
    depth : float
        Per-shard bucket depth (burst tolerance), in tokens.
    clock : callable or None
        Shared time source (the runtime's manual clock).  ``None`` falls
        back to per-arrival refill — fine for unit tests, never for the
        clocked runtime.
    redistribute_every : float or None
        Cadence (in clock time units) of share recomputation toward
        higher-realized-reward shards; ``None`` = static equal split (the
        baseline arm — same buckets, frozen shares).
    min_share : float
        Floor on a shard's share as a fraction of the equal split (0.25 =
        no shard drops below a quarter of ``total_rate / n_shards``) — a
        starved shard keeps enough budget to keep measuring its rewards.
    smooth : float
        EMA step toward the reward-proportional target shares per
        redistribution (1.0 = jump straight to the target).
    reward_halflife : int
        Per-shard realized-reward EMA halflife, in recorded offloads.
    congestion_weight : float
        How strongly a shard's relative uplink congestion (EMA of realized
        queue+transmit sojourns, ``record_congestion``) *discounts* its
        redistribution score: tokens moved to a drowning shard's uplink
        buy latency, not accuracy.  0 disables the signal.
    staleness_weight : float
        How strongly a shard's relative served-result staleness (EMA via
        ``record_staleness``, frames) *boosts* its score: a shard living
        off old edge results needs fresh offloads more than its reward EMA
        alone says.  0 disables the signal.
    """

    def __init__(
        self,
        total_rate: float,
        n_shards: int,
        *,
        depth: float = 8.0,
        clock: Optional[Callable[[], float]] = None,
        redistribute_every: Optional[float] = None,
        min_share: float = 0.25,
        smooth: float = 0.5,
        reward_halflife: int = 32,
        congestion_weight: float = 0.5,
        staleness_weight: float = 0.5,
    ):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if total_rate < 0.0:
            raise ValueError(f"total_rate must be >= 0, got {total_rate}")
        if not 0.0 <= min_share <= 1.0:
            raise ValueError(f"min_share must be in [0, 1], got {min_share}")
        self.total_rate = float(total_rate)
        self.n_shards = int(n_shards)
        self.depth = float(depth)
        self.clock = clock
        self.redistribute_every = (
            None if redistribute_every is None else float(redistribute_every)
        )
        self.min_share = float(min_share)
        self.smooth = float(np.clip(smooth, 0.0, 1.0))
        if congestion_weight < 0 or staleness_weight < 0:
            raise ValueError("congestion_weight/staleness_weight must be >= 0")
        self._alpha = 1.0 - 0.5 ** (1.0 / max(int(reward_halflife), 1))
        self.congestion_weight = float(congestion_weight)
        self.staleness_weight = float(staleness_weight)
        self.shares = np.full(self.n_shards, 1.0 / self.n_shards)
        self._reward_ema = np.zeros(self.n_shards)
        self._reward_seen = np.zeros(self.n_shards, bool)
        self._cong_ema = np.zeros(self.n_shards)
        self._cong_seen = np.zeros(self.n_shards, bool)
        self._stale_ema = np.zeros(self.n_shards)
        self._stale_seen = np.zeros(self.n_shards, bool)
        self._last_redistribution: Optional[float] = None
        self.redistributions = 0
        self.buckets: List[TokenBucket] = [
            TokenBucket(
                rate=self.total_rate * s, depth=self.depth,
                base_threshold=0.0, clock=clock,
            )
            for s in self.shares
        ]

    # ------------------------------------------------------------ admission

    def try_take(self, shard: int) -> bool:
        """Consume one token from ``shard``'s split of the global budget."""
        return self.buckets[shard].try_take()

    def allocated_ratio(self, shard: int, base_ratio: float) -> float:
        """``base_ratio`` scaled by the shard's share relative to the equal
        split — what a ``fleet_fair`` policy budgets its threshold for.
        Equal shares leave the ratio untouched."""
        return float(
            np.clip(base_ratio * self.shares[shard] * self.n_shards, 0.0, 1.0)
        )

    # --------------------------------------------------------- coordination

    def record_reward(self, shard: int, score: float) -> None:
        """Account one realized offload's engine reward score against the
        shard that spent the token — the redistribution signal."""
        if self._reward_seen[shard]:
            self._reward_ema[shard] += self._alpha * (
                float(score) - self._reward_ema[shard]
            )
        else:
            self._reward_ema[shard] = float(score)
            self._reward_seen[shard] = True

    def _ema(self, ema: np.ndarray, seen: np.ndarray, shard: int, v: float) -> None:
        if seen[shard]:
            ema[shard] += self._alpha * (float(v) - ema[shard])
        else:
            ema[shard] = float(v)
            seen[shard] = True

    def record_congestion(self, shard: int, sojourn: float) -> None:
        """Account one realized uplink sojourn (queue + transmit, time
        units) against the shard that paid it — wired by
        :class:`~repro_torch.fleet.runtime.FleetRuntime` from each admitted
        offload's latency breakdown on link-fronted fleets."""
        self._ema(self._cong_ema, self._cong_seen, shard, sojourn)

    def record_staleness(self, shard: int, staleness: float) -> None:
        """Account one served-result staleness sample (frames) against a
        shard — wired from video-serving runtimes whose streams live off
        propagated edge results."""
        self._ema(self._stale_ema, self._stale_seen, shard, staleness)

    def _signal_multiplier(self) -> np.ndarray:
        """Congestion/staleness modifier on the reward scores: relative
        (per-shard EMA over the seen-shard mean), so the signals are
        scale-free — ``(1 + w_s * rel_stale) / (1 + w_c * rel_cong)``.
        Shards with no samples sit at the neutral 1.0."""

        def rel(ema: np.ndarray, seen: np.ndarray) -> np.ndarray:
            if not seen.any():
                return np.ones(self.n_shards)
            mean = float(ema[seen].mean())
            if mean <= 0.0:
                return np.ones(self.n_shards)
            return np.where(seen, ema / mean, 1.0)

        out = np.ones(self.n_shards)
        if self.staleness_weight > 0.0:
            out = out * (
                1.0 + self.staleness_weight * rel(self._stale_ema, self._stale_seen)
            )
        if self.congestion_weight > 0.0:
            out = out / (
                1.0 + self.congestion_weight * rel(self._cong_ema, self._cong_seen)
            )
        return out

    def maybe_redistribute(self, now: float) -> bool:
        """At the configured cadence, move shares toward the
        reward-proportional split (EMA-smoothed, floored at ``min_share`` of
        equal) and retarget the bucket rates.  Levels carry over — a
        redistribution never mints or burns already-accrued tokens — and the
        rates always sum to ``total_rate``."""
        if self.redistribute_every is None:
            return False
        if self._last_redistribution is None:
            self._last_redistribution = float(now)
            return False
        if now - self._last_redistribution < self.redistribute_every:
            return False
        self._last_redistribution = float(now)
        rewards = np.where(
            self._reward_seen, np.maximum(self._reward_ema, 0.0), 0.0
        )
        if rewards.sum() <= 0.0:
            return False
        rewards = rewards * self._signal_multiplier()
        if rewards.sum() <= 0.0:  # pragma: no cover - multiplier is positive
            return False
        # every shard keeps the floor; only the remainder is contested, so
        # the floor survives normalization exactly and the sum stays 1
        floor = self.min_share / self.n_shards
        target = floor + (1.0 - self.min_share) * rewards / rewards.sum()
        self.shares = self.shares + self.smooth * (target - self.shares)
        self.shares /= self.shares.sum()
        for bucket, share in zip(self.buckets, self.shares):
            bucket._refill()  # settle accrual at the old rate first
            bucket.rate = self.total_rate * share
        self.redistributions += 1
        return True

    def stats(self) -> Dict[str, object]:
        return {
            "total_rate": self.total_rate,
            "shares": [float(s) for s in self.shares],
            "levels": [float(b.level) for b in self.buckets],
            "reward_ema": [float(r) for r in self._reward_ema],
            "congestion_ema": [float(c) for c in self._cong_ema],
            "staleness_ema": [float(s) for s in self._stale_ema],
            "redistributions": self.redistributions,
        }


@register_policy("fleet_fair")
class FleetFairPolicy:
    """Shard-local decisions under a coordinated fleet budget.

    The threshold is the quantile at the shard's *allocated* ratio (its
    current share of the global budget) over the shard's **own recent
    scores** — a rolling window of the last ``window`` estimates this
    policy has seen.  That locality matters: a city shard's score
    distribution is skewed relative to the fleet-wide calibration set (an
    easy district's best frame ranks mid-pack globally), and a global
    quantile would leave easy shards hoarding tokens below an unreachable
    threshold while hard shards' integral controllers wind up and spend
    tokens on mediocre frames.  Until the window warms up, the fleet-wide
    calibration distribution stands in.  The shared
    :class:`BudgetTracker` integral controller corrects the residual
    mismatch so the realized shard ratio converges to the allocation; an
    offload additionally consumes a token from the shard's split.  With no
    ``budget`` wired the policy degrades to the integral-tracked local
    quantile threshold on its own ratio (single-device behavior).

    ``budget`` / ``shard`` / ``clock`` are runtime wiring — declared in
    ``context_params`` so ``OffloadEngine.save`` strips them from
    artifacts.  ``clock`` is accepted (sessions inject it) but unused: time
    lives in the budget's buckets.
    """

    context_params = ("budget", "shard", "clock")

    def __init__(
        self,
        calibration_scores: np.ndarray,
        ratio: float,
        gain: float = 0.05,
        window: int = 512,
        warmup: int = 64,
        budget: Optional[FleetBudget] = None,
        shard: int = 0,
        clock: Optional[Callable[[], float]] = None,
    ):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self._cal = np.sort(np.asarray(calibration_scores, dtype=np.float64))
        self.gain = float(gain)
        self.window = int(window)
        self.warmup = max(1, min(int(warmup), self.window))
        self._recent = np.zeros(self.window)
        self._recent_n = 0  # filled entries
        self._recent_pos = 0  # ring-buffer write head
        self.budget = budget
        self.shard = int(shard)
        if budget is not None and not 0 <= self.shard < budget.n_shards:
            raise ValueError(
                f"shard {shard} outside budget's {budget.n_shards} shards"
            )
        self._tracker = BudgetTracker(self.gain)
        self.denied = 0  # wants refused by the token bucket
        self.set_ratio(ratio)

    def set_ratio(self, ratio: float) -> None:
        self.ratio = float(np.clip(ratio, 0.0, 1.0))

    @property
    def allocated_ratio(self) -> float:
        """The ratio this shard currently budgets for: its share-scaled
        slice of the fleet target (just the target when uncoordinated)."""
        if self.budget is None:
            return self.ratio
        return self.budget.allocated_ratio(self.shard, self.ratio)

    def _score_distribution(self) -> np.ndarray:
        """The shard-local recent-score window once warmed up, else the
        fleet-wide calibration distribution."""
        if self._recent_n >= self.warmup:
            return self._recent[: self._recent_n]
        return self._cal

    def _observe(self, estimate: float) -> None:
        self._recent[self._recent_pos] = estimate
        self._recent_pos = (self._recent_pos + 1) % self.window
        self._recent_n = min(self._recent_n + 1, self.window)

    def decide(self, estimate: float) -> bool:
        est = float(estimate)
        want = est > self._tracker.threshold(
            self._score_distribution(), self.allocated_ratio
        )
        self._observe(est)
        offload = want and (
            self.budget is None or self.budget.try_take(self.shard)
        )
        # the controller tracks the WANT rate to the allocation; a token
        # refusal is the bucket's hard cap doing its job, not a shortfall
        # to chase — accounting refusals would wind the threshold down and
        # hand the next refill to whichever mediocre frames arrive first
        self._tracker.account(want)
        self.denied += int(want and not offload)
        return offload

    def decide_batch(self, estimates: np.ndarray) -> np.ndarray:
        # sequential by construction: the bucket level and integral state
        # evolve decision to decision
        return decide_sequential(self, estimates)

    def spec(self) -> Dict[str, object]:
        return {"gain": self.gain, "window": self.window, "warmup": self.warmup}
