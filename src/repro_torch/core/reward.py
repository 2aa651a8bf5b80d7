"""ORIC / ORI offloading reward metrics (paper §IV) + MORIC transform (§V-B).

``RewardOracle`` owns the context set ``E`` (weak-detector results on images
sampled uniformly without replacement from a reference pool — the paper uses
the detector's training distribution) and computes, per image ``i``:

    mAPC_i(d)  = mAP({h_{i,d}} ∪ H_{E,w})                       (Eq. 4)
    ORIC_i     = (|E|+1) · (mAPC_i(s) − mAPC_i(w))              (Eq. 5)
    ORI_i      = mAPI_i(s) − mAPI_i(w)    (E = ∅ special case)  (Eq. 1)

and the rank transform MORIC_i = cdf(ORIC_i)                    (Eq. 6).

Copied from the JAX package (``repro.core.reward``); the batched matching
runs on the port's data plane.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Union

import numpy as np

from repro_torch.kernels.dispatch import DeviceLike
from repro_torch.detection.batch import (
    DetectionsBatch,
    GroundTruthBatch,
    match_batch,
    to_image_evals,
)
from repro_torch.detection.map_engine import (
    APAccumulator,
    Detections,
    GroundTruth,
    ImageEval,
    match_detections,
)


@dataclass
class MatchedImage:
    """Pre-matched weak/strong evaluations for one image (matching is
    per-image, so it is done once and reused across context draws)."""

    weak: ImageEval
    strong: ImageEval


def match_pairs(
    weak_dets: Sequence[Detections],
    strong_dets: Sequence[Detections],
    gts: Sequence[GroundTruth],
    iou_thresholds: Sequence[float] = (0.5,),
) -> List[MatchedImage]:
    """Per-image host matching of both detector outputs (the numpy oracle
    of :func:`match_pairs_batched`)."""
    out = []
    for dw, ds, gt in zip(weak_dets, strong_dets, gts):
        out.append(
            MatchedImage(
                weak=match_detections(dw, gt, iou_thresholds),
                strong=match_detections(ds, gt, iou_thresholds),
            )
        )
    return out


def match_pairs_batched(
    weak_dets: Union[Sequence[Detections], DetectionsBatch],
    strong_dets: Union[Sequence[Detections], DetectionsBatch],
    gts: Union[Sequence[GroundTruth], GroundTruthBatch],
    iou_thresholds: Sequence[float] = (0.5,),
    *,
    device: DeviceLike = "cuda",
) -> List[MatchedImage]:
    """Weak/strong evaluations of every image: both detector outputs are
    matched on device in two :func:`repro_torch.detection.batch.match_batch`
    calls (on the card each one launch of the IoU kernel family's ``match``
    route: IoU, ranking and greedy assignment of every image) instead of 2·N
    per-image Python matches.  Ragged lists are padded onto ``device``;
    batches stay where they are.  The returned ``MatchedImage`` evals are
    structurally identical to the per-image path and feed ``oric_batch`` /
    ``APAccumulator`` unchanged."""
    wb = (
        weak_dets
        if isinstance(weak_dets, DetectionsBatch)
        else DetectionsBatch.from_list(weak_dets, device=device)
    )
    sb = (
        strong_dets
        if isinstance(strong_dets, DetectionsBatch)
        else DetectionsBatch.from_list(strong_dets, device=device)
    )
    gb = (
        gts if isinstance(gts, GroundTruthBatch)
        else GroundTruthBatch.from_list(gts, device=wb.device)
    )
    rw = match_batch(wb, gb, iou_thresholds)
    rs = match_batch(sb, gb, iou_thresholds)
    return [
        MatchedImage(weak=w, strong=s)
        for w, s in zip(to_image_evals(wb, gb, rw), to_image_evals(sb, gb, rs))
    ]


class RewardOracle:
    """Computes exact ORIC (and ORI as the E=∅ degenerate case)."""

    def __init__(
        self,
        context_evals: Sequence[ImageEval],
        iou_thresholds: Sequence[float] = (0.5,),
    ) -> None:
        self.iou_thresholds = tuple(iou_thresholds)
        self.context_size = len(context_evals)
        self._acc = APAccumulator(self.iou_thresholds)
        for ev in context_evals:
            self._acc.add(ev)

    @classmethod
    def from_pool(
        cls,
        pool_weak_evals: Sequence[ImageEval],
        context_size: int,
        rng: np.random.Generator,
        iou_thresholds: Sequence[float] = (0.5,),
    ) -> "RewardOracle":
        """Sample E uniformly without replacement from a weak-result pool."""
        n = len(pool_weak_evals)
        k = min(context_size, n)
        idx = rng.choice(n, size=k, replace=False)
        return cls([pool_weak_evals[int(i)] for i in idx], iou_thresholds)

    def mapc(self, ev: ImageEval) -> float:
        """mAP of {image} ∪ context (Eq. 4)."""
        return self._acc.map_with_image(ev)

    def oric(self, img: MatchedImage) -> float:
        """Eq. 5 — (|E|+1)·(mAPC_s − mAPC_w)."""
        scale = self.context_size + 1
        return scale * (self.mapc(img.strong) - self.mapc(img.weak))

    def oric_batch(self, imgs: Sequence[MatchedImage]) -> np.ndarray:
        """Batched Eq. 5: the context accumulator's base AP sums are hoisted
        out of the loop (two passes total instead of O(N) per-image passes)."""
        scale = self.context_size + 1
        strong = self._acc.map_with_images([im.strong for im in imgs])
        weak = self._acc.map_with_images([im.weak for im in imgs])
        return scale * (strong - weak)


def ori(img: MatchedImage, iou_thresholds: Sequence[float] = (0.5,)) -> float:
    """ORI (Eq. 1 difference): per-image mAPI_s − mAPI_w, no context."""
    empty = APAccumulator(iou_thresholds)
    return empty.map_with_image(img.strong) - empty.map_with_image(img.weak)


def ori_batch(
    imgs: Sequence[MatchedImage], iou_thresholds: Sequence[float] = (0.5,)
) -> np.ndarray:
    """Vectorized ORI via the same hoisted two-pass trick as ``oric_batch``:
    the empty-context accumulator's base AP terms are shared across images
    (trivially zero here), so the whole batch costs two
    ``map_with_images`` passes instead of 2·N accumulator constructions."""
    empty = APAccumulator(iou_thresholds)
    strong = empty.map_with_images([im.strong for im in imgs])
    weak = empty.map_with_images([im.weak for im in imgs])
    return strong - weak


class CdfTransform:
    """Empirical-CDF rank transform (Eq. 6): MORIC = cdf(ORIC) ∈ [0, 1].

    Fit on training rewards; evaluation rewards are mapped by interpolating
    the fitted CDF (mid-rank convention so ties at 0 spread evenly is NOT
    applied — the paper notes exact-0 mass defeats the transform for ORI,
    which we reproduce)."""

    def __init__(self, train_rewards: np.ndarray) -> None:
        r = np.sort(np.asarray(train_rewards, dtype=np.float64))
        self._sorted = r
        self._n = r.size

    def __call__(self, rewards: np.ndarray) -> np.ndarray:
        rewards = np.asarray(rewards, dtype=np.float64)
        # P(R <= r): right-continuous empirical CDF
        ranks = np.searchsorted(self._sorted, rewards, side="right")
        return ranks / max(self._n, 1)

    def state(self) -> dict:
        """Serializable fit state — the public checkpoint surface (callers
        must not reach into ``_sorted``)."""
        return {"sorted_rewards": self._sorted.copy()}

    @classmethod
    def from_state(cls, state: dict) -> "CdfTransform":
        return cls(np.asarray(state["sorted_rewards"], dtype=np.float64))


def cascade_map(
    imgs: Sequence[MatchedImage],
    offload_mask: np.ndarray,
    iou_thresholds: Sequence[float] = (0.5,),
) -> float:
    """Overall mAP of the weak/strong combination given offload decisions
    (the objective of Eq. 2/3)."""
    acc = APAccumulator(iou_thresholds)
    for im, off in zip(imgs, offload_mask):
        acc.add(im.strong if off else im.weak)
    return acc.map()


def topk_offload_mask(scores: np.ndarray, ratio: float) -> np.ndarray:
    """Offload the images whose score is in the top ``ratio`` fraction
    (threshold T = (1-r)-quantile of the scores, paper §III)."""
    n = scores.size
    k = int(round(ratio * n))
    mask = np.zeros(n, dtype=bool)
    if k > 0:
        idx = np.argsort(-scores, kind="stable")[:k]
        mask[idx] = True
    return mask
