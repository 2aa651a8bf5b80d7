"""Online adaptation walkthrough: closing the loop on the frozen engine.

The paper fits its reward estimator once.  But every offloaded frame
returns the strong detection: free supervision for exactly the quantity
the estimator predicts.  ``repro_torch.online`` feeds it back:

1. the drift detector in isolation: why steady selection bias must NOT
   fire, and why a genuine level shift must;
2. the measured network estimator vs the oracle probes on the congested
   fleet (same ``queue_aware`` policy, no simulator internals consulted);
3. the headline: a mid-stream distribution shift served by a frozen vs an
   adaptive engine at the same offload budget
   (``examples/online_adaptation.py``).

Run:  python -m repro_torch.examples.online_adaptation [--device cpu]
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.api import MLPRewardModel, OffloadEngine
from repro_torch.core import EstimatorConfig
from repro_torch.examples import parser
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.online import (
    DriftConfig,
    DriftDetector,
    NetworkEstimator,
    default_shift_scenario,
    run_shift_scenario,
)
from repro_torch.runtime import default_congested_fleet, simulate


def drift_demo() -> dict:
    """Residuals of steady selection bias, then a level shift of ~8 sigma:
    the statistic after the bias, when the detector fired, the ratio
    multiplier, and the state after ``reset``."""
    det = DriftDetector(DriftConfig())
    rng = np.random.default_rng(0)
    # offloaded-subset residuals: constant negative offset (selection bias)
    for r in -0.12 + 0.05 * rng.normal(size=300):
        det.update(predicted=0.0, realized=r)
    out = {"bias_statistic": det.statistic, "threshold": det.config.h,
           "bias_drifted": det.drifted}
    fired_at = None
    for i, r in enumerate(0.30 + 0.05 * rng.normal(size=50)):
        det.update(predicted=0.0, realized=r)
        if det.drifted and fired_at is None:
            fired_at = i + 1
    out.update(fired_at=fired_at, ratio_multiplier=det.ratio_multiplier())
    det.reset()  # the forced refit handles it; baseline re-settles
    out.update(reset_statistic=det.statistic, events=det.events)
    return out


def netstate_engine(x, rewards, *, device="cuda") -> OffloadEngine:
    """The probe study's engine, fitted on ``(x, rewards)``."""
    eng = OffloadEngine(
        reward_model=MLPRewardModel(
            config=EstimatorConfig(hidden=(16,), epochs=10, batch_size=64), device=device
        ),
        ratio=0.3,
    )
    eng.fit(features=x, rewards=rewards)
    return eng


def netstate_demo(device="cuda", n: int = 512) -> dict:
    """``queue_aware`` on the congested fleet with the oracle's probes and
    with measured RTTs: offloads, their mean latency, and the estimator's
    view."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (n, 32)).astype(np.float32)
    rewards = 2.0 * x[:, 0] + 0.3 * rng.normal(size=n)
    qa = netstate_engine(x, rewards, device=device).with_policy("queue_aware")
    out = {}
    for label, net in (("oracle probes", None), ("measured RTT", NetworkEstimator())):
        trace = simulate(
            qa, features=x, edges=default_congested_fleet(3, seed=0),
            ratio=0.3, micro_batch=1, seed=0, net_state=net,
        )
        off = [rec.latency for rec in trace.records if rec.outcome == "offloaded"]
        out[label] = {"offloads": len(off), "mean_offload_latency": float(np.mean(off))}
        if net is not None:
            t = net.telemetry()
            out[label].update(rtt=t["rtt"], bandwidth=t["bandwidth"], delivered=t["delivered"])
    return out


def headline_demo(device="cuda", n_streams: int = 4, n_frames: int = 160,
                  shift_at: int = 64) -> dict:
    """The shift scenario's frozen and adaptive arms."""
    scenario = default_shift_scenario(n_streams, n_frames, shift_at, device=device)
    frozen = run_shift_scenario(scenario)
    adaptive = run_shift_scenario(scenario, adaptive=True)
    out = {}
    for label, arm in (("frozen", frozen), ("adaptive", adaptive)):
        s = arm.summary()
        out[label] = {k: s[k] for k in ("realized_ratio", "pre_shift_effective",
                                        "post_shift_effective")}
    out["updates"] = dict(adaptive.updates)
    out["gain"] = adaptive.mean_effective(post_shift=True) - frozen.mean_effective(post_shift=True)
    return out


def run(device="cuda", *, n_probe: int = 512, n_streams: int = 4, n_frames: int = 160,
        shift_at: int = 64) -> dict:
    """``{"drift": drift_demo(), "netstate": netstate_demo(...), "headline":
    headline_demo(...)}``."""
    dev = resolve_device(device)
    return {"drift": drift_demo(), "netstate": netstate_demo(dev, n_probe),
            "headline": headline_demo(dev, n_streams, n_frames, shift_at)}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parser(__doc__).parse_args(argv)
    out = run(args.device)
    d = out["drift"]
    print("== drift detection on realized-vs-predicted residuals ==")
    print(f"  300 obs of steady bias:  statistic {d['bias_statistic']:5.2f}"
          f"  (threshold {d['threshold']})  drifted={d['bias_drifted']}")
    print(f"  level shift of ~8 sigma:  fired after {d['fired_at']} obs,"
          f"  ratio widened x{d['ratio_multiplier']:.2f}")
    print(f"  after reset: statistic {d['reset_statistic']:.2f}, events {d['events']}")
    print("\n== measured probes vs the oracle (congested fleet) ==")
    for label, p in out["netstate"].items():
        print(f"  {label:14s} offloads={p['offloads']:3d}"
              f"  mean_offload_latency={p['mean_offload_latency']:5.2f}")
        if "rtt" in p:
            print(f"                 estimator view: srtt={p['rtt']:.2f}"
                  f"  bandwidth={p['bandwidth']:.3f}  delivered={p['delivered']:.0f}")
    h = out["headline"]
    print("\n== the headline: mid-stream shift, frozen vs adaptive ==")
    for label in ("frozen", "adaptive"):
        s = h[label]
        print(f"  {label:9s} realized_ratio={s['realized_ratio']:.3f}"
              f"  pre_shift={s['pre_shift_effective']:.3f}"
              f"  post_shift={s['post_shift_effective']:.3f}")
    up = h["updates"]
    print(f"  adaptive arm: {up['observations']} observations ->"
          f" {up['incremental_updates']} incremental updates,"
          f" {up['refits']} refits, {up['drift_events']} drift event(s)")
    print(f"  -> post-shift effective accuracy recovered: {h['gain']:+.3f} AP")
    return out


if __name__ == "__main__":
    main()
