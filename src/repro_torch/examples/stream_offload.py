"""Streaming serve example: one weak device, three heterogeneous edges.

The paper's deployment setting run end to end through the runtime layer:
a fitted ``OffloadEngine`` (the deployable artifact) is wrapped in an
``OffloadRuntime``; frames arrive as a stream, an ``OffloadSession`` scores
micro-batches through the ``estimator_mlp`` kernel and decides in arrival
order, and the ``MultiEdgeDispatcher`` routes accepted offloads across a
capacity- and rate-constrained fleet, degrading to the weak result when
every edge is saturated.  Everything is seeded: re-running gives the
identical per-step trace (``examples/stream_offload.py``).

Run:  python -m repro_torch.examples.stream_offload [--device cpu]
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.api import MLPRewardModel, OffloadEngine, list_policies
from repro_torch.core import EstimatorConfig
from repro_torch.examples import parser
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.runtime import OffloadRuntime, default_edge_fleet, list_strategies, simulate


def fitted_engine(n=4000, d=48, seed=0, *, device="cuda") -> OffloadEngine:
    """A synthetic calibration: reward depends on a few feature directions,
    so the MLP has real structure to learn."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    rewards = 1.5 * x[:, 0] - 0.8 * x[:, 1] + 0.3 * rng.normal(size=n)
    eng = OffloadEngine(
        reward_model=MLPRewardModel(
            config=EstimatorConfig(hidden=(64,), epochs=25, seed=seed), device=device
        ),
        ratio=0.25,
    )
    eng.fit(features=x, rewards=rewards)
    return eng


def run(device="cuda", *, n_calib: int = 4000, n_frames: int = 512) -> dict:
    """The trace's summary numbers (``outcomes``, ``realized_ratio``,
    ``target_ratio``, ``rolling_ratio``, ``mean_offload_latency``, each
    edge's ``accepted`` / ``rejected``), the first 5 records, whether the
    seeded rerun gave the identical records (``rerun_equal``), and each
    strategy's outcome counts under the saturating burst."""
    dev = resolve_device(device)
    engine = fitted_engine(n_calib, 48, device=dev)
    stream = np.random.default_rng(42).normal(0, 1, (n_frames, 48)).astype(np.float32)

    def serve():
        return simulate(
            engine, features=stream, edges=default_edge_fleet(3, seed=1),
            strategy="least_loaded", ratio=0.25, micro_batch=16,
            set_ratio_at={n_frames // 2: 0.5},  # budget doubles halfway through
            seed=1,
        )

    trace = serve()
    s = trace.summary()
    t = s["telemetry"]
    again = serve()  # exact reproducibility: same seed -> identical per-step records
    rerun_equal = again.records == trace.records
    assert rerun_equal

    burst = {}
    for strategy in list_strategies():
        runtime = OffloadRuntime(
            engine, default_edge_fleet(3, seed=2), strategy=strategy, seed=2
        )
        out = runtime.serve(features=stream, ratio=0.6, micro_batch=64).outcome_counts()
        burst[strategy] = {k: out.get(k, 0) for k in ("offloaded", "degraded", "local")}
    return {
        "policies": list_policies(), "strategies": list_strategies(),
        "outcomes": s["outcomes"], "realized_ratio": t["realized_ratio"],
        "target_ratio": t["target_ratio"], "rolling_ratio": t["rolling_ratio"],
        "mean_offload_latency": s["mean_offload_latency"],
        "edges": {name: {"accepted": st["accepted"], "rejected": st["rejected"]}
                  for name, st in s["dispatcher"]["edges"].items()},
        "first_records": [rec.as_dict() for rec in trace.records[:5]],
        "rerun_equal": rerun_equal, "burst": burst,
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parser(__doc__).parse_args(argv)
    out = run(args.device)
    print(f"policies: {out['policies']}   strategies: {out['strategies']}")
    print("\n== one stream, three heterogeneous edges, mid-stream re-budget ==")
    print(f"outcomes: {out['outcomes']}")
    print(
        f"decided ratio={out['realized_ratio']:.3f} (target ended at "
        f"{out['target_ratio']:.2f}), rolling={out['rolling_ratio']:.3f}, "
        f"mean offload latency={out['mean_offload_latency']:.2f}"
    )
    for name, st in out["edges"].items():
        print(f"  {name}: accepted={st['accepted']:4d} rejected={st['rejected']:4d}")
    print("first 5 steps of the trace:")
    for rec in out["first_records"]:
        print(f"  {rec}")
    print("re-run with the same seed: per-step trace identical")
    print("\n== strategies under a saturating burst ==")
    for strategy, c in out["burst"].items():
        print(f"  {strategy:15s} offloaded={c['offloaded']:4d} "
              f"degraded={c['degraded']:4d} local={c['local']:4d}")
    return out


if __name__ == "__main__":
    main()
