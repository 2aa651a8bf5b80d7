"""Moving clients, coverage-dependent links, and mid-stream handover.

1. seeded mobility traces: the device rollout matches the pure-Python
   reference oracle and reruns bit-identically;
2. the coverage map: per-position signal strength, rate factors, and the
   time-to-coverage-loss probe the ``mobility_aware`` policy discounts by;
3. the headline: handover-aware dispatch vs static edge pinning at the
   same realized offload budget;
4. in-flight semantics: what happens to results still in transit when
   their source station is abandoned (survive / die / stale)
   (``examples/mobility_handover.py``).

Run:  python -m repro_torch.examples.mobility_handover [--device cpu]
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.examples import parser
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.mobility import (
    CoverageMap,
    MotionConfig,
    default_mobile_scenario,
    default_stations,
    rollout,
    rollout_ref,
    run_mobile_scenario,
)

MODELS = ("waypoint", "random_walk")
IN_FLIGHT = ("survive", "die", "stale")


def motion_demo(device="cuda") -> dict:
    """Each motion model's ``max_abs`` (rollout against ``rollout_ref``)
    and ``rerun_identical``."""
    out = {}
    for model in MODELS:
        cfg = MotionConfig(model=model, area=(1000.0, 600.0), speed=12.0)
        scan = rollout(cfg, 4, 80, seed=0, device=device)
        ref = rollout_ref(cfg, 4, 80, seed=0)
        again = rollout(cfg, 4, 80, seed=0, device=device)
        out[model] = {"max_abs": float(np.abs(scan - ref).max()),
                      "rerun_identical": bool(np.array_equal(scan, again))}
    return out


def coverage_demo() -> list:
    """A client walking the corridor left to right: at t = 0, 15, 30 the
    best station, its RSS, the rate factor and the time to coverage loss."""
    cov = CoverageMap(default_stations(3, area=(1200.0, 600.0)))
    T = 60
    trace = np.stack([np.linspace(50.0, 1150.0, T), np.full(T, 300.0)], axis=-1)
    rows = []
    for t in (0, 15, 30):
        i, rss = cov.best(trace[t])
        rows.append({"t": t, "best": i, "rss": rss, "rate_factor": cov.rate_factor(rss),
                     "time_to_loss": cov.time_to_loss(trace, t, dt=1.0)})
    return rows


def headline_demo(device="cuda", n_clients: int = 4, n_steps: int = 160) -> dict:
    """Handover vs static pinning on ``default_mobile_scenario``."""
    sc = default_mobile_scenario(n_clients=n_clients, n_steps=n_steps, seed=0, device=device)
    out = {}
    for name, mode in (("static pin", "static"), ("handover", "handover")):
        tr = run_mobile_scenario(sc, mode)
        out[name] = {"effective_acc": tr.mean_effective_accuracy(),
                     "realized_ratio": tr.realized_ratio(), "handovers": tr.n_handovers()}
    out["gain"] = out["handover"]["effective_acc"] - out["static pin"]["effective_acc"]
    return out


def in_flight_demo(device="cuda", n_clients: int = 4, n_steps: int = 160) -> dict:
    """Handover under each in-flight mode: effective accuracy, cancelled
    results and mean staleness."""
    sc = default_mobile_scenario(n_clients=n_clients, n_steps=n_steps, seed=0, device=device)
    out = {}
    for mode in IN_FLIGHT:
        tr = run_mobile_scenario(sc, "handover", in_flight=mode)
        out[mode] = {
            "effective_acc": tr.mean_effective_accuracy(),
            "cancelled": sum(e.get("cancelled", 0) for e in tr.dispatcher["edges"].values()),
            "mean_staleness": float(np.mean([t.mean_staleness for t in tr.telemetry])),
        }
    return out


def run(device="cuda", *, n_clients: int = 4, n_steps: int = 160) -> dict:
    """``{"motion", "coverage", "headline", "in_flight"}``."""
    dev = resolve_device(device)
    return {"motion": motion_demo(dev), "coverage": coverage_demo(),
            "headline": headline_demo(dev, n_clients, n_steps),
            "in_flight": in_flight_demo(dev, n_clients, n_steps)}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parser(__doc__).parse_args(argv)
    out = run(args.device)
    print("== seeded motion: device rollout vs Python reference ==")
    for model, m in out["motion"].items():
        print(f"  {model:12s} max|scan-ref| = {m['max_abs']:.2e}"
              f"   rerun bit-identical: {m['rerun_identical']}")
    print("== coverage: signal, rate factor, time-to-loss ==")
    for r in out["coverage"]:
        ttl = "inf" if np.isinf(r["time_to_loss"]) else f"{r['time_to_loss']:.0f}"
        print(f"  t={r['t']:2d}  best=bs{r['best']}  rss={r['rss']:6.1f} dBm"
              f"  rate_factor={r['rate_factor']:.2f}  time_to_loss={ttl}")
    print("== headline: handover-aware dispatch vs static pinning ==")
    h = out["headline"]
    for name in ("static pin", "handover"):
        print(f"  {name:11s} eff.acc={h[name]['effective_acc']:.4f}"
              f"  realized_ratio={h[name]['realized_ratio']:.3f}"
              f"  handovers={h[name]['handovers']}")
    print(f"  gain: {h['gain']:+.4f} effective accuracy at equal offload budget")
    print("== in-flight semantics at the moment of handover ==")
    for mode, m in out["in_flight"].items():
        print(f"  {mode:8s} eff.acc={m['effective_acc']:.4f}"
              f"  cancelled={m['cancelled']:3d}  mean_staleness={m['mean_staleness']:.2f}")
    return out


if __name__ == "__main__":
    main()
