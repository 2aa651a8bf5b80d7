"""The reproduction pipeline of ``repro.experiments.detection_repro``, up to
the deployable engine (paper §IV–§V):

  1. generate the procedural train / val / pool splits,
  2. train the weak and strong detectors,
  3. run both over val and pool (forward + NMS), match against the ground
     truth, and take the weak detector's box features on val,
  4. ORIC rewards on val against a context drawn from the pool, and the
     fitted ``OffloadEngine`` (``build_engine``).

Only ``PipelineState``, ``build_pipeline`` and ``build_engine`` are ported
here.  The paper's figures and tables come later (ROADMAP.md, queue A item
3): they need ``tide``, the baselines and ``ori_batch``, which the port does
not have yet.

The state is cached as ``torch_pipeline_state.pkl`` and the detectors as
``torch_detector_<name>.npz`` (``repro``'s HWIO layout, readable by
``repro.train.checkpoint.load_pytree`` and ``convert.detector_params_from_jax``)
under ``REPRO_ARTIFACTS`` (default ``artifacts/``) or ``cache_dir``: names of
their own, because ``repro``'s pickle holds ``repro`` classes.
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.api import DetectionBoxFeatures, MLPRewardModel, OffloadEngine
from repro_torch.convert import detector_params_to_jax
from repro_torch.core.estimator import EstimatorConfig
from repro_torch.core.features import extract_features_batch
from repro_torch.core.reward import MatchedImage, RewardOracle, match_pairs_batched
from repro_torch.data.shapes import NUM_CLASSES, ShapesDataset
from repro_torch.detection.batch import (
    DetectionsBatch,
    GroundTruthBatch,
    match_batch,
    to_image_evals,
)
from repro_torch.detection.map_engine import Detections, dataset_map
from repro_torch.kernels.dispatch import DeviceLike, resolve_device
from repro_torch.models.detector import STRONG, WEAK, decode_detections
from repro_torch.serving import timing
from repro_torch.train.checkpoint import save_pytree
from repro_torch.train.trainer import train_detector

ARTIFACTS = os.environ.get(
    "REPRO_ARTIFACTS", os.path.join(os.path.dirname(__file__), "../../../artifacts")
)


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
    stage_ms: timing.StageMs = None,
) -> PipelineState:
    """Train, run and match both detectors (``repro``'s stages, seeds and
    defaults) on ``device``; cached unless ``force``.  ``stage_ms``
    accumulates ``data_ms``, ``train_weak_ms``, ``train_strong_ms``,
    ``decode_ms``, ``match_ms``, ``map_ms`` and ``features_ms`` when given."""
    dev = resolve_device(device)
    root = ARTIFACTS if cache_dir is None else cache_dir
    os.makedirs(root, exist_ok=True)
    cache = os.path.join(root, "torch_pipeline_state.pkl")
    if os.path.exists(cache) and not force:
        with open(cache, "rb") as f:  # written by this function
            return pickle.load(f)

    t0 = timing.now(stage_ms, dev)
    if verbose:
        print("[pipeline] generating data ...")
    train = ShapesDataset.generate(n_train, seed=seed)
    val = ShapesDataset.generate(n_val, seed=seed + 1)
    pool = ShapesDataset.generate(n_pool, seed=seed + 2)
    t0 = timing.add(stage_ms, "data_ms", t0, dev)

    detectors, losses = {}, {}
    for cfg, steps in ((WEAK, steps_weak), (STRONG, steps_strong)):
        if verbose:
            print(f"[pipeline] training {cfg.name} detector ({steps} steps) ...")
        det, losses[cfg.name] = train_detector(cfg, train, steps=steps, seed=seed + 10, device=dev)
        save_pytree(os.path.join(root, f"torch_detector_{cfg.name}.npz"),
                    detector_params_to_jax(det.state_dict()))
        detectors[cfg.name] = det
        t0 = timing.add(stage_ms, f"train_{cfg.name}_ms", t0, dev)

    if verbose:
        print("[pipeline] running inference on val + pool ...")
    weak_val = decode_detections(detectors["weak"], val.images)
    strong_val = decode_detections(detectors["strong"], val.images)
    weak_pool = decode_detections(detectors["weak"], pool.images)
    t0 = timing.add(stage_ms, "decode_ms", t0, dev)

    # the batched data plane: pad once, match on the device (one launch of
    # the IoU family's match route a call), then the per-image evals
    weak_val_batch = DetectionsBatch.from_list(weak_val, device=dev)
    val_pairs = match_pairs_batched(weak_val_batch, strong_val, val.gts, device=dev)
    pool_batch = DetectionsBatch.from_list(weak_pool, device=dev)
    pool_gt_batch = GroundTruthBatch.from_list(pool.gts, device=dev)
    pool_weak_evals = to_image_evals(
        pool_batch, pool_gt_batch, match_batch(pool_batch, pool_gt_batch, (0.5,))
    )
    t0 = timing.add(stage_ms, "match_ms", t0, dev)
    weak_map = dataset_map(weak_val, val.gts)
    strong_map = dataset_map(strong_val, val.gts)
    t0 = timing.add(stage_ms, "map_ms", t0, dev)
    if verbose:
        print(f"[pipeline] weak mAP={weak_map:.4f} strong mAP={strong_map:.4f}")
    feats = extract_features_batch(
        weak_val_batch, NUM_CLASSES, image_size=float(WEAK.image_size)
    ).cpu().numpy()
    timing.add(stage_ms, "features_ms", t0, dev)
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
