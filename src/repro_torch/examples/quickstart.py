"""Quickstart: the paper's offloading pipeline end to end.

Trains tiny weak/strong detectors on the procedural dataset, computes exact
ORIC rewards, trains the MORIC estimator, and prints the mAP achieved by
each offloading policy at a 20% budget (``examples/quickstart.py``).

Run:  python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core import (
    CdfTransform,
    EstimatorConfig,
    RewardEstimator,
    RewardOracle,
    cascade_map,
    extract_features_batch,
    match_pairs,
    random_offload_mask,
    topk_offload_mask,
)
from repro_torch.data.shapes import ShapesDataset
from repro_torch.detection.map_engine import dataset_map, match_detections
from repro_torch.examples import parser
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.detector import STRONG, WEAK, decode_detections
from repro_torch.train.trainer import train_detector


def run(device="cuda", *, n_train: int = 600, n_val: int = 200, n_pool: int = 200,
        steps_weak: int = 150, steps_strong: int = 300, context_size: int = 150,
        epochs: int = 30) -> dict:
    """``{"weak_map", "strong_map", "rows": {policy: mAP}, "rewards"}``
    (``rewards``: the val split's ORIC rewards)."""
    dev = resolve_device(device)
    print("== data ==")
    train = ShapesDataset.generate(n_train, seed=0)
    val = ShapesDataset.generate(n_val, seed=1)
    pool = ShapesDataset.generate(n_pool, seed=2)

    print("== detectors ==")
    pw, _ = train_detector(WEAK, train, steps=steps_weak, log_every=50, device=dev)
    ps, _ = train_detector(STRONG, train, steps=steps_strong, log_every=100, device=dev)

    weak_val = decode_detections(pw, val.images)
    strong_val = decode_detections(ps, val.images)
    weak_pool = decode_detections(pw, pool.images)
    weak_map = dataset_map(weak_val, val.gts)
    strong_map = dataset_map(strong_val, val.gts)
    print(f"weak mAP={weak_map:.4f}  strong mAP={strong_map:.4f}")

    print("== ORIC rewards (oracle) ==")
    rng = np.random.default_rng(0)
    pairs = match_pairs(weak_val, strong_val, val.gts)
    pool_evals = [match_detections(d, g, (0.5,)) for d, g in zip(weak_pool, pool.gts)]
    oracle = RewardOracle.from_pool(pool_evals, context_size, rng)
    rewards = oracle.oric_batch(pairs)

    print("== MORIC estimator ==")
    x = extract_features_batch(weak_val, 8, image_size=64.0, device=dev)
    cdf = CdfTransform(rewards)
    est = RewardEstimator(x.shape[1], EstimatorConfig(epochs=epochs), device=dev)
    est.fit(x, cdf(rewards))
    preds = est.predict(x)

    r = 0.2
    rows = {
        "weak only": cascade_map(pairs, np.zeros(len(pairs), bool)),
        "strong only": cascade_map(pairs, np.ones(len(pairs), bool)),
        "random @20%": cascade_map(pairs, random_offload_mask(len(pairs), r, rng)),
        "ORIC oracle @20%": cascade_map(pairs, topk_offload_mask(rewards, r)),
        "MORIC estimator @20%": cascade_map(pairs, topk_offload_mask(preds, r)),
    }
    return {"weak_map": weak_map, "strong_map": strong_map, "rows": rows,
            "rewards": np.asarray(rewards)}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parser(__doc__).parse_args(argv)
    out = run(args.device)
    print("\npolicy                     mAP")
    for k, v in out["rows"].items():
        print(f"{k:25s} {v:.4f}")
    return out


if __name__ == "__main__":
    main()
