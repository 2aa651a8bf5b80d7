"""The faithful end-to-end reproduction pipeline (paper §IV–§V), ported
from ``repro.experiments.detection_repro``.

Stages (all cached under ``artifacts/`` or ``cache_dir``):
  1. generate procedural train/val/pool splits,
  2. train weak + strong detectors,
  3. run both detectors over val + pool (forward + NMS), match against the
     ground truth, and take the weak detector's box features on val,
  4. compute ORI / ORIC oracles, the MORIC transform, train estimators
     (``build_engine`` is the deployable one),
  5. evaluate every policy (oracle + estimated + baselines) across ratios.

Each paper figure/table has a ``figure_*``/``table_*`` function reading from
the pipeline state; ``run_all`` runs them all (``python -m
repro_torch.experiments.detection_repro [--quick] [--force]``).  The
rewards, TIDE, the mAPs and the DCSB and random baselines are host numpy,
drawing from one ``np.random.default_rng(seed)`` a function in ``repro``'s
order, so from the same ``PipelineState`` they equal that package's
exactly; the detectors, the matching and every fit run on ``device``.

The state is cached as ``torch_pipeline_state.pkl``, the detectors as
``torch_detector_<name>.npz`` (``repro``'s HWIO layout, readable by
``repro.train.checkpoint.load_pytree`` and ``convert.detector_params_from_jax``)
and ``run_all``'s results as ``torch_repro_results.json``, under
``REPRO_ARTIFACTS`` (default ``artifacts/``) or ``cache_dir``: names of
their own, because ``repro``'s pickle holds ``repro`` classes.
"""
from __future__ import annotations

import json
import os
import pickle
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.api import (
    CNNRewardModel,
    DetectionBoxFeatures,
    MLPRewardModel,
    OffloadEngine,
    make_policy,
)
from repro_torch.convert import detector_params_from_jax, detector_params_to_jax
from repro_torch.core import (
    AdaptiveFeedingSVM,
    CdfTransform,
    EstimatorConfig,
    MatchedImage,
    RewardOracle,
    cascade_map,
    dcsb_signals,
    extract_features_batch,
    fit_dcsb,
    match_pairs_batched,
    ori_batch,
    random_offload_mask,
    topk_offload_mask,
)
from repro_torch.data.shapes import NUM_CLASSES, ShapesDataset
from repro_torch.detection.batch import (
    DetectionsBatch,
    GroundTruthBatch,
    match_batch,
    to_image_evals,
)
from repro_torch.detection.map_engine import Detections, dataset_map
from repro_torch.detection.tide import tide_errors
from repro_torch.kernels.dispatch import DeviceLike, resolve_device
from repro_torch.models.detector import (
    STRONG,
    WEAK,
    Detector,
    DetectorConfig,
    decode_detections,
    detector_forward,
)
from repro_torch.obs.trace import stage
from repro_torch.train.checkpoint import load_pytree, save_pytree
from repro_torch.train.trainer import train_detector

ARTIFACTS = os.environ.get(
    "REPRO_ARTIFACTS", os.path.join(os.path.dirname(__file__), "../../../artifacts")
)


def _cache_root(cache_dir: Optional[str]) -> str:
    root = ARTIFACTS if cache_dir is None else cache_dir
    os.makedirs(root, exist_ok=True)
    return root


@dataclass
class PipelineState:
    """Everything downstream experiments need, detector-free; plus each
    detector's training loss trace."""

    val_pairs: List[MatchedImage]
    pool_weak_evals: list
    weak_dets_val: List[Detections]
    strong_dets_val: List[Detections]
    val_gts: list
    weak_map: float
    strong_map: float
    features_val: np.ndarray
    image_size: float
    train_losses: Dict[str, List[float]] = field(default_factory=dict)


def build_pipeline(
    n_train: int = 3000,
    n_val: int = 2000,
    n_pool: int = 1200,
    steps_weak: int = 500,
    steps_strong: int = 900,
    seed: int = 0,
    force: bool = False,
    verbose: bool = True,
    *,
    device: DeviceLike = "cuda",
    cache_dir: Optional[str] = None,
    stage_ms: Optional[Dict[str, float]] = None,
) -> PipelineState:
    """Train, run and match both detectors (``repro``'s stages, seeds and
    defaults) on ``device``; cached unless ``force``.  ``stage_ms``
    accumulates ``data_ms``, ``train_weak_ms``, ``train_strong_ms``,
    ``decode_ms``, ``match_ms``, ``map_ms`` and ``features_ms`` when given."""
    dev = resolve_device(device)
    root = _cache_root(cache_dir)
    cache = os.path.join(root, "torch_pipeline_state.pkl")
    if os.path.exists(cache) and not force:
        with open(cache, "rb") as f:  # written by this function
            return pickle.load(f)

    def timed(key: str):
        return stage(None, f"pipeline.{key[:-3]}", stage_ms=stage_ms, key=key, device=dev)

    with timed("data_ms"):
        if verbose:
            print("[pipeline] generating data ...")
        train = ShapesDataset.generate(n_train, seed=seed)
        val = ShapesDataset.generate(n_val, seed=seed + 1)
        pool = ShapesDataset.generate(n_pool, seed=seed + 2)

    detectors, losses = {}, {}
    for cfg, steps in ((WEAK, steps_weak), (STRONG, steps_strong)):
        with timed(f"train_{cfg.name}_ms"):
            if verbose:
                print(f"[pipeline] training {cfg.name} detector ({steps} steps) ...")
            det, losses[cfg.name] = train_detector(cfg, train, steps=steps, seed=seed + 10,
                                                   device=dev)
            save_pytree(os.path.join(root, f"torch_detector_{cfg.name}.npz"),
                        detector_params_to_jax(det.state_dict()))
            detectors[cfg.name] = det

    with timed("decode_ms"):
        if verbose:
            print("[pipeline] running inference on val + pool ...")
        weak_val = decode_detections(detectors["weak"], val.images)
        strong_val = decode_detections(detectors["strong"], val.images)
        weak_pool = decode_detections(detectors["weak"], pool.images)

    # the batched data plane: pad once, match on the device (one launch of
    # the IoU family's match route a call), then the per-image evals
    with timed("match_ms"):
        weak_val_batch = DetectionsBatch.from_list(weak_val, device=dev)
        val_pairs = match_pairs_batched(weak_val_batch, strong_val, val.gts, device=dev)
        pool_batch = DetectionsBatch.from_list(weak_pool, device=dev)
        pool_gt_batch = GroundTruthBatch.from_list(pool.gts, device=dev)
        pool_weak_evals = to_image_evals(
            pool_batch, pool_gt_batch, match_batch(pool_batch, pool_gt_batch, (0.5,))
        )
    with timed("map_ms"):
        weak_map = dataset_map(weak_val, val.gts)
        strong_map = dataset_map(strong_val, val.gts)
    if verbose:
        print(f"[pipeline] weak mAP={weak_map:.4f} strong mAP={strong_map:.4f}")
    with timed("features_ms"):
        feats = extract_features_batch(
            weak_val_batch, NUM_CLASSES, image_size=float(WEAK.image_size)
        ).cpu().numpy()
    state = PipelineState(
        val_pairs=val_pairs,
        pool_weak_evals=pool_weak_evals,
        weak_dets_val=weak_val,
        strong_dets_val=strong_val,
        val_gts=val.gts,
        weak_map=weak_map,
        strong_map=strong_map,
        features_val=feats,
        image_size=float(WEAK.image_size),
        train_losses=losses,
    )
    with open(cache, "wb") as f:
        pickle.dump(state, f)
    return state


def build_engine(
    state: PipelineState,
    context_size: int = 800,
    ratio: float = 0.2,
    seed: int = 0,
    epochs: int = 40,
    hidden: Tuple[int, ...] = (128,),
    *,
    device: DeviceLike = "cuda",
) -> OffloadEngine:
    """The deployable artifact: ORIC rewards on the calibration split -> one
    ``OffloadEngine`` fitted on ``device`` over the weak detector's box
    features.  The default single hidden layer makes batched scoring take
    the ``estimator_mlp`` kernel; ``engine.save(path)`` ships the stack."""
    rng = np.random.default_rng(seed)
    oracle = RewardOracle.from_pool(state.pool_weak_evals, context_size, rng)
    rewards = oracle.oric_batch(state.val_pairs)
    engine = OffloadEngine(
        feature_extractor=DetectionBoxFeatures(
            num_classes=NUM_CLASSES, image_size=state.image_size, device=device
        ),
        reward_model=MLPRewardModel(
            config=EstimatorConfig(hidden=tuple(hidden), epochs=epochs, seed=seed), device=device
        ),
        ratio=ratio,
    )
    engine.fit(state.weak_dets_val, rewards)
    return engine


def load_detector(
    cfg: DetectorConfig, *, device: DeviceLike = "cuda", cache_dir: Optional[str] = None
) -> Detector:
    """The detector ``build_pipeline`` trained, from its
    ``torch_detector_<name>.npz`` cache, on ``device``."""
    det = Detector(cfg, device=device)
    like = detector_params_to_jax(det.state_dict())
    path = os.path.join(_cache_root(cache_dir), f"torch_detector_{cfg.name}.npz")
    det.load_state_dict(detector_params_from_jax(load_pytree(path, like)))
    return det


# ---------------------------------------------------------------------------
# Paper figure/table analogues
# ---------------------------------------------------------------------------

def figure5_context_size(
    state: PipelineState,
    context_sizes: Sequence[int] = (0, 25, 50, 100, 200, 400, 800),
    ratios: Sequence[float] = (0.1, 0.2, 0.5),
    n_draws: int = 5,
    seed: int = 0,
) -> Dict:
    """Oracle mAP vs |E| for ORIC (|E|=0 == ORI), per offloading ratio."""
    rng = np.random.default_rng(seed)
    out: Dict = {"context_sizes": list(context_sizes), "ratios": list(ratios),
                 "weak_map": state.weak_map, "strong_map": state.strong_map,
                 "curves": {}}
    # rewards once per (E, draw); reuse across ratios
    rewards_by_size: Dict[int, List[np.ndarray]] = {}
    for E in context_sizes:
        draws = 1 if E == 0 else n_draws
        rewards_by_size[E] = [
            RewardOracle.from_pool(state.pool_weak_evals, E, rng).oric_batch(
                state.val_pairs
            )
            for _ in range(draws)
        ]
    for r in ratios:
        means, cis = [], []
        for E in context_sizes:
            vals = np.array(
                [
                    cascade_map(state.val_pairs, topk_offload_mask(rw, r))
                    for rw in rewards_by_size[E]
                ]
            )
            means.append(float(vals.mean()))
            cis.append(float(1.96 * vals.std() / np.sqrt(max(len(vals), 1))))
        out["curves"][f"r={r}"] = {"mean": means, "ci95": cis}
    return out


def _oric_and_ori(state: PipelineState, context_size: int, rng: np.random.Generator):
    """ORIC against a context drawn from the pool (``rng``'s first draw),
    and ORI."""
    oracle = RewardOracle.from_pool(state.pool_weak_evals, context_size, rng)
    return oracle.oric_batch(state.val_pairs), ori_batch(state.val_pairs)


def table2_conservatism(
    state: PipelineState, context_size: int = 800, seed: int = 0
) -> Dict:
    """Weak/strong mAP on reward<=0 vs reward>0 subsets, ORIC vs ORI."""
    oric, ori_r = _oric_and_ori(state, context_size, np.random.default_rng(seed))
    out: Dict = {}
    for name, rewards in (("ORIC", oric), ("ORI", ori_r)):
        for label, mask in (
            ("nonpos", rewards <= 0),
            ("pos", rewards > 0),
        ):
            idx = np.where(mask)[0]
            sub = [state.val_pairs[i] for i in idx]
            out[f"{name}_{label}"] = {
                "pct": float(mask.mean() * 100),
                "weak_map": cascade_map(sub, np.zeros(len(sub), bool)) if len(sub) else float("nan"),
                "strong_map": cascade_map(sub, np.ones(len(sub), bool)) if len(sub) else float("nan"),
            }
    return out


def figure6_error_types(
    state: PipelineState, ratio: float = 0.2, context_size: int = 800, seed: int = 0
) -> Dict:
    """TIDE 6-category error decomposition of weak/strong/ORI/ORIC cascades."""
    oric, ori_r = _oric_and_ori(state, context_size, np.random.default_rng(seed))
    configs = {
        "weak": np.zeros(len(state.val_pairs), bool),
        "strong": np.ones(len(state.val_pairs), bool),
        "ORI": topk_offload_mask(ori_r, ratio),
        "ORIC": topk_offload_mask(oric, ratio),
    }
    out: Dict = {}
    for name, mask in configs.items():
        dets = [
            state.strong_dets_val[i] if mask[i] else state.weak_dets_val[i]
            for i in range(len(mask))
        ]
        out[name] = tide_errors(dets, state.val_gts)
    return out


def figure8_reward_cdf(state: PipelineState, context_size: int = 800, seed: int = 0) -> Dict:
    oric, ori_r = _oric_and_ori(state, context_size, np.random.default_rng(seed))
    qs = np.linspace(0, 1, 21)
    return {
        "oric_quantiles": np.quantile(oric, qs).tolist(),
        "ori_quantiles": np.quantile(ori_r, qs).tolist(),
        "oric_frac_zero": float(np.mean(np.abs(oric) < 1e-9)),
        "ori_frac_zero": float(np.mean(np.abs(ori_r) < 1e-9)),
    }


@dataclass
class EstimatorBundle:
    """Estimators trained with 5-fold CV; predictions are out-of-fold."""

    preds: Dict[str, np.ndarray]
    rewards: Dict[str, np.ndarray]


def train_estimators(
    state: PipelineState,
    context_size: int = 800,
    seed: int = 0,
    folds: int = 5,
    epochs: int = 40,
    *,
    device: DeviceLike = "cuda",
) -> EstimatorBundle:
    """Out-of-fold predictions for MORIC / vanilla-ORIC / ORI / MORI, each
    fold's engine fitted and scored on ``device``."""
    rng = np.random.default_rng(seed)
    oric, ori_r = _oric_and_ori(state, context_size, rng)
    x = state.features_val
    n = x.shape[0]
    fold_ix = np.arange(n) % folds
    rng.shuffle(fold_ix)

    def oof(targets: np.ndarray, weighted: bool, sigmoid: bool, rank: bool) -> np.ndarray:
        preds = np.zeros(n)
        for f in range(folds):
            tr = fold_ix != f
            te = ~tr
            engine = OffloadEngine(
                reward_model=MLPRewardModel(
                    config=EstimatorConfig(weighted=weighted, sigmoid_out=sigmoid,
                                           epochs=epochs, seed=seed + f),
                    device=device,
                ),
                transform="cdf" if rank else None,
            )
            engine.fit(features=x[tr], rewards=targets[tr])
            preds[te] = engine.score(features=x[te])
        return preds

    preds = {
        "MORIC": oof(oric, weighted=True, sigmoid=True, rank=True),
        "ORIC_vanilla": oof(oric, weighted=False, sigmoid=False, rank=False),
        "ORI": oof(ori_r, weighted=False, sigmoid=False, rank=False),
        "MORI": oof(ori_r, weighted=True, sigmoid=True, rank=True),
    }
    return EstimatorBundle(preds=preds, rewards={"ORIC": oric, "ORI": ori_r})


def evaluate_policies(
    state: PipelineState,
    bundle: EstimatorBundle,
    ratios: Sequence[float] = (0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.7, 1.0),
    seed: int = 0,
    *,
    device: DeviceLike = "cuda",
) -> Dict:
    """mAP-vs-ratio for every policy (Fig. 9/10 analogue).  mAPs are also
    reported normalized: 0% = weak alone, 100% = strong alone.  The
    Adaptive Feeding SVMs are fitted on ``device``."""
    rng = np.random.default_rng(seed)
    n = len(state.val_pairs)
    out: Dict = {
        "ratios": list(ratios),
        "weak_map": state.weak_map,
        "strong_map": state.strong_map,
        "curves": {},
    }

    def norm(m: float) -> float:
        return 100.0 * (m - state.weak_map) / max(state.strong_map - state.weak_map, 1e-9)

    policies: Dict[str, np.ndarray] = {
        "oracle_ORIC": bundle.rewards["ORIC"],
        "oracle_ORI": bundle.rewards["ORI"],
        **{f"est_{k}": v for k, v in bundle.preds.items()},
    }
    for name, scores in policies.items():
        maps = [cascade_map(state.val_pairs, topk_offload_mask(scores, r)) for r in ratios]
        out["curves"][name] = {"map": maps, "norm": [norm(m) for m in maps]}
    # random baseline (mean over 5 draws)
    maps = []
    for r in ratios:
        vals = [
            cascade_map(state.val_pairs, random_offload_mask(n, r, rng))
            for _ in range(5)
        ]
        maps.append(float(np.mean(vals)))
    out["curves"]["random"] = {"map": maps, "norm": [norm(m) for m in maps]}

    # Adaptive Feeding: one SVM per c_plus; ratio is whatever the SVM yields
    af_pts = []
    difficult = bundle.rewards["ORI"] > 0
    for c_plus in (2.0 ** e for e in range(-3, 3)):
        svm = AdaptiveFeedingSVM(c_plus=float(c_plus), epochs=60, device=device).fit(
            state.features_val, difficult
        )
        mask = svm.predict(state.features_val)
        af_pts.append(
            {"c_plus": float(c_plus), "ratio": float(mask.mean()),
             "map": cascade_map(state.val_pairs, mask)}
        )
    for p in af_pts:
        p["norm"] = norm(p["map"])
    out["adaptive_feeding"] = af_pts

    # DCSB: rule search fixes its own ratio
    rule = fit_dcsb(state.weak_dets_val, state.strong_dets_val)
    counts, areas = dcsb_signals(state.weak_dets_val)
    mask = rule.predict_signals(counts, areas)
    out["dcsb"] = {
        "ratio": float(mask.mean()),
        "map": cascade_map(state.val_pairs, mask),
        "norm": norm(cascade_map(state.val_pairs, mask)),
        "thr_count": rule.thr_count,
        "thr_area": rule.thr_area,
    }
    return out


def val_feature_maps(
    n_val: int, *, device: DeviceLike = "cuda", cache_dir: Optional[str] = None
) -> np.ndarray:
    """The cached weak detector's backbone feature maps (N, G, G, C) over
    the val split regenerated from its seed, 256 images a forward."""
    val = ShapesDataset.generate(n_val, seed=1)
    weak = load_detector(WEAK, device=device, cache_dir=cache_dir)
    return np.concatenate([
        detector_forward(weak, val.images[s : s + 256])[3].cpu().numpy()
        for s in range(0, n_val, 256)
    ])


def figure7_input_study(
    state: PipelineState,
    context_size: int = 800,
    ratios: Sequence[float] = (0.1, 0.2, 0.3, 0.5),
    seed: int = 0,
    epochs: int = 30,
    n_val: int = 2000,
    *,
    device: DeviceLike = "cuda",
    cache_dir: Optional[str] = None,
) -> Dict:
    """§V-A input study: estimate MORIC from the weak detector's OUTPUT
    (MLP on box features) vs from its backbone FEATURE MAPS (CNN) — the
    early-exit integration point.  Paper finding: limited impact.  Both
    estimators run behind the OffloadEngine reward-model interface, on
    ``device``.  The feature maps come from the weak detector that
    ``build_pipeline`` cached in ``cache_dir``, over the val split
    regenerated from its seed; ``n_val`` must be the state's val size
    (the default fits a full pipeline)."""
    rng = np.random.default_rng(seed)
    oracle = RewardOracle.from_pool(state.pool_weak_evals, context_size, rng)
    oric = oracle.oric_batch(state.val_pairs)
    cdf = CdfTransform(oric)
    y = cdf(oric)

    fmaps = val_feature_maps(n_val, device=device, cache_dir=cache_dir)

    # 2-fold CV: both input variants behind the engine's RewardModel
    # interface (targets are already rank-transformed, so transform=None)
    n = len(y)
    fold = np.arange(n) % 2
    rng.shuffle(fold)
    preds_cnn = np.zeros(n)
    preds_mlp = np.zeros(n)
    for f in range(2):
        tr, te = fold != f, fold == f
        cnn_engine = OffloadEngine(
            reward_model=CNNRewardModel(epochs=epochs, seed=seed + f, device=device),
            transform=None,
        )
        cnn_engine.fit(features=fmaps[tr], rewards=y[tr])
        preds_cnn[te] = cnn_engine.score(features=fmaps[te])

        mlp_engine = OffloadEngine(
            reward_model=MLPRewardModel(config=EstimatorConfig(epochs=epochs), device=device),
            transform=None,
        )
        mlp_engine.fit(features=state.features_val[tr], rewards=y[tr])
        preds_mlp[te] = mlp_engine.score(features=state.features_val[te])

    out: Dict = {"ratios": list(ratios), "curves": {}}
    for name, preds in (("output_mlp", preds_mlp), ("featmap_cnn", preds_cnn)):
        out["curves"][name] = [
            cascade_map(state.val_pairs, topk_offload_mask(preds, r)) for r in ratios
        ]
    return out


def token_bucket_study(
    state: PipelineState,
    bundle: EstimatorBundle,
    rate: float = 0.2,
    depth: float = 8.0,
    seed: int = 0,
) -> Dict:
    """Dynamic-budget serving ([23]-style): a token bucket enforcing a hard
    offload rate on a streaming trace vs the static threshold policy.  Both
    policies come from the OffloadEngine registry, calibrated on the same
    estimate distribution."""
    rng = np.random.default_rng(seed)
    est = bundle.preds["MORIC"]
    order = rng.permutation(len(est))  # arrival order
    # static threshold at the same target ratio
    pol = make_policy("threshold", est, ratio=rate)
    static_mask = np.zeros(len(est), bool)
    static_mask[order] = pol.decide_batch(est[order])
    tb = make_policy("token_bucket", est, ratio=rate, depth=depth)
    tb_mask = np.zeros(len(est), bool)
    tb_mask[order] = tb.decide_batch(est[order])
    return {
        "target_rate": rate,
        "static": {"ratio": float(static_mask.mean()),
                   "map": cascade_map(state.val_pairs, static_mask)},
        "token_bucket": {"ratio": float(tb_mask.mean()),
                         "map": cascade_map(state.val_pairs, tb_mask),
                         "max_burst": depth},
    }


def streaming_multi_edge_study(
    state: PipelineState,
    engine: Optional[OffloadEngine] = None,
    *,
    context_size: int = 800,
    ratio: float = 0.2,
    n_edges: int = 3,
    strategy: str = "least_loaded",
    micro_batch: int = 16,
    epochs: int = 40,
    seed: int = 0,
    device: DeviceLike = "cuda",
) -> Dict:
    """Beyond-batch serving: the paper's deployment picture as a stream.

    Val images arrive one at a time (seeded arrival order) at one weak
    device; an :class:`repro_torch.runtime.OffloadSession` scores
    micro-batches through the engine (fitted on ``device`` unless given)
    and decides in arrival order; accepted offloads are dispatched across
    ``n_edges`` heterogeneous rate-limited edges.  Frames the saturated
    fleet degrades fall back to the weak result, so the realized cascade
    mAP prices in serve-time constraints that the one-shot
    ``engine.decide`` evaluation cannot see."""
    from repro_torch.runtime import default_edge_fleet, simulate

    if engine is None:
        engine = build_engine(
            state, context_size=context_size, ratio=ratio, seed=seed, epochs=epochs,
            device=device,
        )
    rng = np.random.default_rng(seed)
    n = len(state.val_pairs)
    order = rng.permutation(n)  # arrival order of the stream
    trace = simulate(
        engine,
        features=state.features_val[order],
        edges=default_edge_fleet(n_edges, seed=seed),
        strategy=strategy,
        ratio=ratio,
        micro_batch=micro_batch,
        seed=seed,
    )
    # trace records are in arrival order; map the *served* offloads (admitted
    # by an edge) back to dataset order for the mAP accounting
    served_mask = np.zeros(n, bool)
    wanted_mask = np.zeros(n, bool)
    for rec in trace.records:
        served_mask[order[rec.step]] = rec.outcome == "offloaded"
        wanted_mask[order[rec.step]] = rec.offload
    return {
        "target_ratio": ratio,
        "strategy": strategy,
        "n_edges": n_edges,
        "decided_ratio": float(wanted_mask.mean()),
        "served_ratio": float(served_mask.mean()),
        "map_served": cascade_map(state.val_pairs, served_mask),
        "map_unconstrained": cascade_map(state.val_pairs, wanted_mask),
        "weak_map": state.weak_map,
        "strong_map": state.strong_map,
        "summary": trace.summary(),
    }


def _plain(obj: Any) -> Any:
    """``obj`` with every number a Python ``float`` / ``int`` and every
    sequence a list, for ``json.dump``."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, np.ndarray):
        return _plain(obj.tolist())
    if isinstance(obj, (bool, np.bool_)):
        return bool(obj)
    if isinstance(obj, (int, np.integer)):
        return int(obj)
    if isinstance(obj, (float, np.floating)):
        return float(obj)
    return obj


def run_all(
    force: bool = False,
    quick: bool = False,
    *,
    device: DeviceLike = "cuda",
    cache_dir: Optional[str] = None,
    stage_ms: Optional[Dict[str, float]] = None,
) -> Dict:
    """Full repro on ``device``; writes ``torch_repro_results.json`` to the
    cache dir.  ``quick`` cuts the splits and the training as ``repro``'s
    does (1200 / 400 / 500 images, 250 / 400 detector steps, context 400)
    and, like it, leaves out Fig. 7 and the token-bucket study.
    ``stage_ms`` accumulates the pipeline's stages (``build_pipeline``'s
    own keys) and one key a figure or study, when given."""
    dev = resolve_device(device)
    kw = dict(n_train=1200, n_val=400, n_pool=500, steps_weak=250, steps_strong=400) if quick else {}
    state = build_pipeline(force=force, device=dev, cache_dir=cache_dir, stage_ms=stage_ms, **kw)
    results: Dict = {
        "weak_map": state.weak_map,
        "strong_map": state.strong_map,
    }
    ctx = 400 if quick else 800

    def timed(key: str, fn, *args, **kwargs) -> Any:
        with stage(None, f"repro.{key[:-3]}", stage_ms=stage_ms, key=key, device=dev):
            return fn(*args, **kwargs)

    results["figure5"] = timed(
        "figure5_ms", figure5_context_size, state,
        context_sizes=(0, 25, 100, ctx // 2, ctx) if quick else (0, 25, 50, 100, 200, 400, 800),
        n_draws=3 if quick else 5,
    )
    results["table2"] = timed("table2_ms", table2_conservatism, state, context_size=ctx)
    results["figure6"] = timed("figure6_ms", figure6_error_types, state, context_size=ctx)
    results["figure8"] = timed("figure8_ms", figure8_reward_cdf, state, context_size=ctx)
    bundle = timed("train_estimators_ms", train_estimators, state, context_size=ctx,
                   epochs=20 if quick else 40, device=dev)
    results["figure9_10"] = timed("figure9_10_ms", evaluate_policies, state, bundle, device=dev)
    results["streaming_multi_edge"] = timed(
        "streaming_ms", streaming_multi_edge_study, state, context_size=ctx,
        epochs=10 if quick else 40, device=dev,
    )
    if not quick:
        results["figure7"] = timed("figure7_ms", figure7_input_study, state, context_size=ctx,
                                   device=dev, cache_dir=cache_dir)
        results["token_bucket"] = timed("token_bucket_ms", token_bucket_study, state, bundle)
    results = _plain(results)
    path = os.path.join(_cache_root(cache_dir), "torch_repro_results.json")
    with open(path, "w") as f:
        json.dump(results, f, indent=2)
    print(f"[pipeline] wrote {path}")
    return results


if __name__ == "__main__":
    import sys

    # run through the canonical module so pickled classes resolve on import
    from repro_torch.experiments import detection_repro as _mod

    _mod.run_all(force="--force" in sys.argv, quick="--quick" in sys.argv)
