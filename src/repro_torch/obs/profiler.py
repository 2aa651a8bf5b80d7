"""`DispatchProfiler` — wall-clock attribution of host-loop time to named
phases.

The serve loop's cost is host-side Python (the ROADMAP's dispatcher fps
regression is "runtime-, not kernel-bound"), so the profiler measures
``perf_counter`` intervals and accumulates them per phase name.  The
instrumentation pattern keeps the disabled path to a single ``is None``
check per phase:

    prof = obs.profiler if obs is not None else None
    ...
    t0 = prof.begin() if prof is not None else 0.0
    do_phase()
    if prof is not None:
        prof.add("phase_name", t0)

``begin``/``add`` are bound-method calls around ``perf_counter`` — no
context-manager frames, no dict churn beyond one setdefault-free lookup
(phase lists are created on first use and reused).

On the card a launch returns before its work is done: a phase that
launches kernels closes after the host copy that waits for them (the
session closes ``session.score`` after its estimates reach the host).
Copied from the JAX package (``repro.obs.profiler``).
"""
from __future__ import annotations

import time
from typing import Dict, List


class DispatchProfiler:
    """Accumulates ``perf_counter`` seconds per named phase."""

    __slots__ = ("_acc", "_clock")

    def __init__(self) -> None:
        # phase -> [total_seconds, count]
        self._acc: Dict[str, List[float]] = {}
        self._clock = time.perf_counter

    def begin(self) -> float:
        return self._clock()

    def add(self, phase: str, t0: float) -> None:
        cell = self._acc.get(phase)
        if cell is None:
            cell = self._acc[phase] = [0.0, 0]
        cell[0] += self._clock() - t0
        cell[1] += 1

    # ------------------------------------------------------------- reporting

    def totals(self) -> Dict[str, float]:
        return {phase: cell[0] for phase, cell in self._acc.items()}

    def report(self) -> Dict[str, Dict[str, float]]:
        """Per-phase ``{total_ms, count, mean_us, share}`` sorted by cost
        (dict order = descending total)."""
        grand = sum(cell[0] for cell in self._acc.values()) or 1.0
        rows = sorted(self._acc.items(), key=lambda kv: -kv[1][0])
        return {
            phase: {
                "total_ms": cell[0] * 1e3,
                "count": int(cell[1]),
                "mean_us": (cell[0] / cell[1] * 1e6) if cell[1] else 0.0,
                "share": cell[0] / grand,
            }
            for phase, cell in rows
        }

    def format_report(self) -> str:
        lines = [f"{'phase':<28}{'total ms':>10}{'count':>10}{'mean µs':>10}{'share':>8}"]
        for phase, row in self.report().items():
            lines.append(
                f"{phase:<28}{row['total_ms']:>10.2f}{row['count']:>10d}"
                f"{row['mean_us']:>10.2f}{row['share']:>7.1%}"
            )
        return "\n".join(lines)

    def clear(self) -> None:
        self._acc.clear()
