"""Deterministic time sources for the streaming runtime.

Nothing in the runtime reads the wall clock: every time-dependent component
(token-bucket refill, edge service completion) takes either an explicit
``now`` argument or an injected zero-arg clock callable.  ``ManualClock`` is
the canonical injectable clock for simulations and tests.

Copied from the JAX package (``repro.runtime.clock``).
"""
from __future__ import annotations


class ManualClock:
    """A hand-advanced monotone clock: ``clock()`` reads, ``advance`` moves."""

    def __init__(self, t: float = 0.0) -> None:
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        dt = float(dt)
        # NaN poisons every downstream schedule silently; `not (dt >= 0)`
        # catches it along with negative steps
        if not (dt >= 0):
            raise ValueError(f"clock cannot go backwards or take NaN (dt={dt})")
        self.t += dt
        return self.t
