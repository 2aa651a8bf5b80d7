"""The paper's full evaluation (Figs. 5/9/10, Table II) from the cached
pipeline: runs the complete experiment suite, prints a summary, then fits
the deployable ``OffloadEngine`` artifact and round-trips it through
save/load (``examples/offload_detection.py``).

Run:  python -m repro_torch.examples.offload_detection [--quick] [--force] [--device cpu]
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.api import OffloadEngine
from repro_torch.examples import artifact, parser
from repro_torch.experiments.detection_repro import build_engine, build_pipeline, run_all
from repro_torch.kernels.dispatch import resolve_device


PROBE = 64  # images decided before and after the artifact's round trip


def run(device="cuda", *, quick: bool = False, force: bool = False) -> dict:
    """The suite's results (``run_all``'s dict), plus the artifact's:
    ``engine_path``, ``fused``, ``probe_ratio``, ``round_trip_exact`` and
    ``rebudget_ratio`` (the reloaded engine's ratio after ``set_ratio(0.5)``)."""
    dev = resolve_device(device)
    results = run_all(force=force, quick=quick, device=dev)

    # ---- deployable artifact: fit, save, reload, verify ------------------
    state = build_pipeline(device=dev)  # cached by run_all above
    engine = build_engine(
        state, context_size=400 if quick else 800, ratio=0.2, epochs=10 if quick else 40,
        device=dev,
    )
    path = artifact("offload_engine")
    engine.save(path)
    reloaded = OffloadEngine.load(path, device=dev)
    probe = state.weak_dets_val[:PROBE]
    d1, d2 = engine.decide(probe), reloaded.decide(probe)
    exact = bool(np.array_equal(d1.offload, d2.offload)
                 and np.array_equal(d1.estimates, d2.estimates))
    assert exact, "save/load round trip diverged"
    reloaded.set_ratio(0.5)
    return {**results, "engine_path": path, "fused": engine.reward_model.fused,
            "n_probe": len(probe), "probe_ratio": d1.ratio, "round_trip_exact": exact,
            "rebudget_ratio": reloaded.decide(probe).ratio}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    out = run(args.device, quick=args.quick, force=args.force)

    print("\n===== summary =====")
    print(f"weak mAP {out['weak_map']:.4f}   strong mAP {out['strong_map']:.4f}")
    print("\nFig. 5 (oracle mAP vs |E|, r=0.2):")
    f5 = out["figure5"]
    for e, m in zip(f5["context_sizes"], f5["curves"]["r=0.2"]["mean"]):
        print(f"  |E|={e:4d}: {m:.4f}")
    print("\nFig. 10 (normalized mAP, % of weak->strong gap closed):")
    for name, cur in out["figure9_10"]["curves"].items():
        pts = ", ".join(f"{v:.0f}" for v in cur["norm"][:6])
        print(f"  {name:18s} [{pts}]  @ratios {out['figure9_10']['ratios'][:6]}")
    print("\n===== OffloadEngine artifact =====")
    print(f"saved {out['engine_path']}.npz  (fused kernel scoring: {out['fused']})")
    print(f"decisions on {out['n_probe']} probe images: ratio={out['probe_ratio']:.2f}, "
          "round trip exact")
    print(f"runtime re-budget to 0.5: ratio={out['rebudget_ratio']:.2f}")
    return out


if __name__ == "__main__":
    main()
