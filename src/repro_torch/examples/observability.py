"""Observability walkthrough: metrics + tracing + profiling on one run.

``repro_torch.obs`` puts one handle over the whole serve stack.  Pass
``obs=`` to any runtime entry point and three planes light up:

- a ``MetricsRegistry`` the session/dispatcher/edge counters live in
  (Prometheus text + JSON exporters, snapshot/delta),
- a ``Tracer`` stamping nested spans from the simulation's manual clock
  (byte-identical traces under a fixed seed) exported as Chrome-trace
  JSON: open it in Perfetto or chrome://tracing,
- a ``DispatchProfiler`` attributing host-loop wall time to serve phases,
  plus the kernels' launches since the handle was built (where the JAX
  package counts jit retraces).

This example runs the seeded congested-fleet scenario with everything on,
prints the Prometheus exposition and the profiler table, and writes
``obs_trace.json`` / ``obs_metrics.json`` to the working directory
(``examples/observability.py``).

Run:  python -m repro_torch.examples.observability [--device cpu]
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.api import MLPRewardModel, OffloadEngine
from repro_torch.core import EstimatorConfig
from repro_torch.examples import parser
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.obs import Obs
from repro_torch.runtime import default_congested_fleet, simulate

SHOWN = ("repro_realized_ratio", "repro_dispatch_total", "repro_edge_queue_depth",
         "repro_offload_rtt_sum", "repro_offload_rtt_count", "repro_kernel_launches_total")
TRACE_FILE = "obs_trace.json"
METRICS_FILE = "obs_metrics.json"


def fitted_engine(n=2000, d=24, seed=0, *, device="cuda") -> OffloadEngine:
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    rewards = 1.5 * x[:, 0] - 0.8 * x[:, 1] + 0.3 * rng.normal(size=n)
    eng = OffloadEngine(
        reward_model=MLPRewardModel(
            config=EstimatorConfig(hidden=(32,), epochs=20, seed=seed), device=device
        ),
        ratio=0.3,
    )
    eng.fit(features=x, rewards=rewards)
    return eng


def run(device="cuda", *, n_calib: int = 2000, n_frames: int = 512) -> dict:
    """``{"processed", "offloaded", "realized_ratio", "prometheus" (the
    shown lines), "prometheus_lines", "profile" (the report), "launches"
    (by kernel, since the handle was built), "n_events"}``."""
    dev = resolve_device(device)
    engine = fitted_engine(n_calib, 24, device=dev)
    stream = np.random.default_rng(7).normal(0, 1, (n_frames, 24)).astype(np.float32)

    obs = Obs()  # metrics + tracing + profiling; obs=None stays the free default
    trace = simulate(
        engine,
        features=stream,
        edges=default_congested_fleet(3, seed=5),
        ratio=0.3,
        micro_batch=32,
        seed=5,
        obs=obs,
    )
    t = trace.telemetry
    text = obs.metrics.to_prometheus()
    obs.tracer.export(TRACE_FILE)
    obs.metrics.export_json(METRICS_FILE)
    return {
        "processed": t.processed, "offloaded": t.offloaded, "realized_ratio": t.realized_ratio,
        "prometheus": [line for line in text.splitlines() if line.startswith(SHOWN)],
        "prometheus_lines": len(text.splitlines()),
        "profile": obs.profiler.format_report(),
        "launches": obs.kernel_delta()["launches"],
        "n_events": len(obs.tracer.events),
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parser(__doc__).parse_args(argv)
    out = run(args.device)
    print("== run ==")
    print(f"  processed {out['processed']}  offloaded {out['offloaded']}"
          f"  realized_ratio {out['realized_ratio']:.3f}")
    print("\n== Prometheus exposition (what a scraper would see) ==")
    for line in out["prometheus"]:
        print(f"  {line}")
    print(f"  ... ({len(out['prometheus'])} of {out['prometheus_lines']} lines shown)")
    print("\n== host-phase profile (where the serve loop's time went) ==")
    print("  " + out["profile"].replace("\n", "\n  "))
    print("\n== kernel launches since the handle was built ==")
    for kernel, n in sorted(out["launches"].items()):
        if n:
            print(f"  {kernel:32s} launches={n}")
    print(f"\nwrote {TRACE_FILE} ({out['n_events']} events: load it in Perfetto)")
    print(f"wrote {METRICS_FILE} (structured series dump)")
    print("rerun with the same seed: both files are byte-identical.")
    return out


if __name__ == "__main__":
    main()
