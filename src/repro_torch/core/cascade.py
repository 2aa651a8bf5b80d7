"""Generic weak/strong cascade orchestration (the paper's Fig. 4 pipeline).

Domain-agnostic: a ``Cascade`` pairs a weak inference fn, a reward-estimate
fn (reading only weak output), a strong inference fn, and a decision policy.
The canonical construction path is :meth:`Cascade.from_engine`, which wires
the estimate fn and policy from a fitted :class:`repro_torch.api.OffloadEngine`;
the explicit-field form remains for hand-rolled stacks.

Copied from the JAX package (``repro.core.cascade``).  A weak output that is
a one-frame :class:`~repro_torch.detection.batch.DetectionsBatch` (what
``models.detector.decode_batch`` returns) is scored through
``engine.score_device``: one ``score_pipeline`` launch an item on the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterable, List

import numpy as np

from repro_torch.detection.batch import DetectionsBatch


@dataclass
class CascadeRecord:
    """Per-item trace for accounting/latency breakdown (paper Table III)."""

    estimate: float
    offloaded: bool
    weak_output: Any
    final_output: Any


@dataclass
class Cascade:
    weak_fn: Callable[[Any], Any]
    estimate_fn: Callable[[Any], float]  # weak output -> reward estimate
    strong_fn: Callable[[Any], Any]
    policy: Any  # anything with decide(estimate) -> bool

    @classmethod
    def from_engine(
        cls,
        weak_fn: Callable[[Any], Any],
        strong_fn: Callable[[Any], Any],
        engine,
    ) -> "Cascade":
        """Item-at-a-time cascade driven by a fitted ``OffloadEngine``: the
        engine's reward model scores each weak output and its policy decides."""
        if engine.policy is None:
            raise ValueError("engine must be fit() before building a Cascade")

        def estimate(weak_out: Any) -> float:
            if isinstance(weak_out, DetectionsBatch):
                return float(engine.score_device(weak_out)[0])
            return float(engine.score([weak_out])[0])

        return cls(
            weak_fn=weak_fn,
            estimate_fn=estimate,
            strong_fn=strong_fn,
            policy=engine.policy,
        )

    def process(self, item: Any) -> CascadeRecord:
        weak_out = self.weak_fn(item)
        est = float(self.estimate_fn(weak_out))
        offload = self.policy.decide(est)
        final = self.strong_fn(item) if offload else weak_out
        return CascadeRecord(est, offload, weak_out, final)

    def run(self, items: Iterable[Any]) -> List[CascadeRecord]:
        return [self.process(it) for it in items]

    def offload_ratio(self, records: List[CascadeRecord]) -> float:
        if not records:
            return 0.0
        return float(np.mean([r.offloaded for r in records]))
