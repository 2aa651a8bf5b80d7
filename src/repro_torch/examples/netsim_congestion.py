"""Network simulation walkthrough: congestion-aware offloading end to end.

The paper's deployment setting puts the strong detector behind a
rate-constrained wireless uplink.  ``repro_torch.netsim`` makes that link
explicit (size-dependent transmission delay, a bounded FIFO uplink queue,
and a seeded Gilbert-Elliott fading channel) and adds two queue-aware
decision policies on top of the ``OffloadEngine`` registry:

- ``queue_aware``     threshold on the congestion-discounted estimate with
                      an integral budget tracker (defer in fades, pay back
                      after),
- ``value_iteration`` the (queue depth x channel state) MDP, solved on the
                      engine's device.

This example (1) shows the raw netsim pieces, (2) runs the seeded
congestion scenario under ``threshold`` vs ``queue_aware`` vs
``value_iteration`` at the same budget, and (3) sweeps the value-iteration
thresholds over a whole ratio grid in one batched solve
(``examples/netsim_congestion.py``).

Run:  python -m repro_torch.examples.netsim_congestion [--device cpu]
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.api import MLPRewardModel, OffloadEngine
from repro_torch.core import EstimatorConfig
from repro_torch.examples import parser
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.netsim import GilbertElliottLink, UplinkQueue, value_iteration_sweep
from repro_torch.runtime import default_congested_fleet, simulate

SWEEP_RATIOS = (0.1, 0.3, 0.5)


def fitted_engine(n=2000, d=24, seed=0, *, device="cuda") -> OffloadEngine:
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    rewards = 1.5 * x[:, 0] - 0.8 * x[:, 1] + 0.3 * rng.normal(size=n)
    eng = OffloadEngine(
        reward_model=MLPRewardModel(
            config=EstimatorConfig(hidden=(32,), epochs=20, seed=seed), device=device
        ),
        ratio=0.35,
    )
    eng.fit(features=x, rewards=rewards)
    return eng


def queue_demo() -> dict:
    """Eight frames through a fading link behind a bounded FIFO: each
    frame's ``(queue_delay, transmit_delay, t_delivered)`` or ``None``
    (dropped), and the queue's conservation stats."""
    link = GilbertElliottLink(
        bandwidth=0.5, bad_bandwidth=0.125, p_gb=0.1, p_bg=0.3, seed=4
    )
    queue = UplinkQueue(link, depth=6, frame_bits=1.0)
    frames = []
    for step in range(8):
        f = queue.enqueue(0.6 * step, step)
        frames.append(None if f is None else (f.queue_delay, f.transmit_delay, f.t_delivered))
    queue.poll(1e9)
    return {"frames": frames, "stats": queue.stats()}


def run(device="cuda", *, n_calib: int = 2000, n_frames: int = 400) -> dict:
    """``{"queue": queue_demo(), "policies": {name: {"realized_ratio",
    "mean_latency", "queue", "transmit", "service"}}, "thetas" (ratio x
    queue depth x channel)}``."""
    dev = resolve_device(device)
    out = {"queue": queue_demo()}
    engine = fitted_engine(n_calib, 24, device=dev)
    stream = np.random.default_rng(42).normal(0, 1, (n_frames, 24)).astype(np.float32)
    policies = {
        "threshold": engine,
        "queue_aware": engine.with_policy("queue_aware"),
        "value_iteration": engine.with_policy(
            "value_iteration", policy_kwargs=dict(max_queue=12, delay_cost=0.03)
        ),
    }
    out["policies"] = {}
    for name, eng in policies.items():
        trace = simulate(
            eng, features=stream, edges=default_congested_fleet(3, seed=5),
            ratio=0.35, micro_batch=1, seed=5,
        )
        s = trace.summary()
        d = s["latency_decomposition"] or {}
        out["policies"][name] = {
            "realized_ratio": s["telemetry"]["realized_ratio"],
            "mean_latency": s["mean_offload_latency"],
            **{k: d.get(k, 0) for k in ("queue", "transmit", "service")},
        }
    out["thetas"] = value_iteration_sweep(
        engine.calibration_scores, list(SWEEP_RATIOS), max_queue=8, n_sweeps=60, device=dev
    )
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parser(__doc__).parse_args(argv)
    out = run(args.device)
    print("== the raw pieces: a fading link behind a bounded FIFO ==")
    for step, f in enumerate(out["queue"]["frames"]):
        if f is None:
            print(f"  frame {step}: DROPPED (queue full)")
        else:
            print(f"  frame {step}: wait {f[0]:5.2f}  transmit {f[1]:5.2f}"
                  f"  delivered t={f[2]:5.2f}")
    print(f"  conservation: {out['queue']['stats']}")
    print("\n== seeded congestion scenario, three policies, one budget ==")
    for name, p in out["policies"].items():
        print(
            f"  {name:16s} realized_ratio={p['realized_ratio']:.3f}"
            f"  mean_latency={p['mean_latency']:6.2f}"
            f"  (queue {p['queue']:5.2f} + transmit {p['transmit']:5.2f}"
            f" + service {p['service']:4.2f})"
        )
    print("  -> queue-aware policies trade the queue component away at the")
    print("     same offload budget; the trace proves where the time went.")
    print("\n== value-iteration threshold tables, one batched solve ==")
    thetas = out["thetas"]
    print(f"  theta grid shape {thetas.shape}  (ratio x queue-depth x channel)")
    for r, th in zip(SWEEP_RATIOS, thetas):
        print(
            f"  ratio {r:.1f}: offload threshold rises"
            f" q=0 {th[0, 0]:.2f} -> q=8 {th[8, 0]:.2f} (good)"
            f" | bad channel q=0 {th[0, 1]:.2f}"
        )
    return out


if __name__ == "__main__":
    main()
