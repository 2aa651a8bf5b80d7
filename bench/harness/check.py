"""Whether what the window served is correct: the program's answers for
the sampled requests against the reference's, each number beside its
limit (``bench/limits/<workload>.json``; a cell compares the numbers its
file gives a limit, in the order of ``readings``).

The numbers, over the sampled requests, NLL in nats:

* ``nll_weak_gap`` / ``nll_strong_gap``: the largest |program - reference|
  of the per-request mean NLL of the weak (early-exit) and the strong (full
  depth) pass;
* ``nll_weak_rms`` / ``nll_strong_rms``: the root mean square of the same
  differences, steadier from seed to seed than the largest;
* ``nll_final_rms``: the same for the blended NLL against the reference's
  NLL of the pass the program's decision chose;
* ``policy_errors``: requests whose offload decision is not what the
  threshold policy gives for the program's own estimate (offload iff the
  estimate is above the threshold that the program's artifact defines).
  An exact count, limit 0: it sees a decision altered after the estimate;
* ``decision_flips``: requests whose offload decision differs from the
  reference's although the reference's margin (logit(estimate) -
  logit(threshold), its decision stack calibrated on its own weak pass over
  the calibration prompts) lies farther from 0 than the file's
  ``flip_band_logit``: a decision that close may go either way on rounding.
  An exact count, limit 0;
* ``logit_margin_gap``: the largest |program's margin - reference's
  margin|, in logits: it sees an estimator or a standardisation gone wrong.

``outside_band_share``, the share of sampled requests whose reference
margin lies outside the band (those ``decision_flips`` judges), is read and
reported beside them, as is any number the limits file gives no limit.  A
number that is not finite fails.
"""
from __future__ import annotations

import sys
from typing import Dict

import numpy as np

NUMBERS = ("nll_weak_gap", "nll_strong_gap", "nll_weak_rms", "nll_strong_rms", "nll_final_rms",
           "policy_errors", "decision_flips", "logit_margin_gap", "outside_band_share")


def _diff(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a - b if a.shape == b.shape and a.size else np.array([np.inf])


def _gap(a, b) -> float:
    return float(np.max(np.abs(_diff(a, b))))


def _rms(a, b) -> float:
    return float(np.sqrt(np.mean(np.square(_diff(a, b)))))


def logit(p) -> np.ndarray:
    """log(p / (1 - p)) in float64, p kept inside float32's resolution."""
    p = np.clip(np.asarray(p, np.float64), 1e-7, 1.0 - 1e-7)
    return np.log(p) - np.log1p(-p)


def margins(side: Dict) -> np.ndarray:
    return logit(side["estimates"]) - logit(side["threshold"])


def readings(prog: Dict, refr: Dict, band: float) -> Dict[str, float]:
    """Every number, the program's (or the control's) answers in ``prog``
    against the reference's in ``refr``."""
    off = np.asarray(prog["offload"], bool)
    est = np.asarray(prog["estimates"], np.float64)
    m_p, m_r = margins(prog), margins(refr)
    chosen = np.where(off, refr["nll_strong"], refr["nll_weak"])
    same = off.shape == m_r.shape == est.shape
    outside = np.abs(m_r) > band
    return {
        "nll_weak_gap": _gap(prog["nll_weak"], refr["nll_weak"]),
        "nll_strong_gap": _gap(prog["nll_strong"], refr["nll_strong"]),
        "nll_weak_rms": _rms(prog["nll_weak"], refr["nll_weak"]),
        "nll_strong_rms": _rms(prog["nll_strong"], refr["nll_strong"]),
        "nll_final_rms": _rms(prog["nll_final"], chosen),
        "policy_errors": float((off != (est > prog["threshold"])).sum()) if same else float("inf"),
        "decision_flips": float(((off != np.asarray(refr["offload"], bool)) & outside).sum())
        if same else float("inf"),
        "logit_margin_gap": _gap(m_p, m_r),
        "outside_band_share": float(outside.mean()),
    }


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    """Each number that ``limits`` gives a limit, with it; a number passes
    when it is finite and not above its limit."""
    return {k: {"value": v, "limit": limits[k], "ok": bool(np.isfinite(v) and v <= limits[k])}
            for k, v in values.items() if k in limits}


def report(values: Dict[str, float], checks: Dict[str, Dict]) -> None:
    """The numbers read but not compared, then the compared numbers beside
    their limits, as the last lines on stderr."""
    for k, v in values.items():
        if k not in checks:
            print(f"read {k} {v!r}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r} {'ok' if c['ok'] else 'FAIL'}",
              file=sys.stderr)
