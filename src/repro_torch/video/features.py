"""Temporal features over a stream of weak detector outputs.

The per-image stack scores each frame in isolation; these helpers add the
signals that only exist *between* frames:

- :func:`detection_overlap` / :func:`frame_difference` — how much of the
  current weak output is explained by the previous frame's (greedy IoU,
  class-gated), plus count/score drift;
- :func:`scene_change_score` — a [0, 1] cut detector mixing the overlap
  complement with tracker churn (births + deaths per live track, from
  :meth:`repro_torch.video.track.TrackFrame.churn`);
- :class:`EwmaSmoother` — exponentially-weighted smoothing of the per-frame
  reward estimate, the temporal prior SmartDet-style policies lean on.

Everything is pure host-side arithmetic over already-extracted outputs —
cheap per frame, deterministic, no device round-trips.  Copied from the JAX
package (``repro.video.features``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from repro_torch.detection.map_engine import Detections
from repro_torch.video.track import greedy_match_boxes


def detection_overlap(
    prev: Detections, cur: Detections, iou_thresh: float = 0.5
) -> float:
    """Fraction of current detections greedy-matched (class-gated, IoU >=
    ``iou_thresh``) to the previous frame's — 1.0 for a static scene, ~0
    across a cut.  Empty current frames count as fully explained."""
    if not len(cur):
        return 1.0
    if not len(prev):
        return 0.0
    match = greedy_match_boxes(
        cur.boxes,
        cur.scores,
        prev.boxes,
        iou_thresh,
        eligible=np.asarray(cur.classes)[:, None]
        == np.asarray(prev.classes)[None, :],
    )
    return float((match >= 0).mean())


def frame_difference(prev: Optional[Detections], cur: Detections) -> Dict[str, float]:
    """Frame-to-frame drift statistics of the weak output: detection-count
    delta, mean-score delta, and the matched-overlap fraction.  ``prev``
    may be None (stream start): treated as a full change."""
    if prev is None:
        return {"count_delta": float(len(cur)), "score_delta": 0.0, "overlap": 0.0}
    mean = lambda d: float(np.mean(d.scores)) if len(d) else 0.0
    return {
        "count_delta": float(len(cur) - len(prev)),
        "score_delta": mean(cur) - mean(prev),
        "overlap": detection_overlap(prev, cur),
    }


def scene_change_score(
    overlap: float, churn: float, *, overlap_weight: float = 0.6
) -> float:
    """Blend the two cut signals into one [0, 1] score: low frame-to-frame
    overlap and high tracker churn both push toward 1."""
    w = float(np.clip(overlap_weight, 0.0, 1.0))
    score = w * (1.0 - float(overlap)) + (1.0 - w) * float(churn)
    return float(np.clip(score, 0.0, 1.0))


@dataclass
class EwmaSmoother:
    """Exponentially-weighted moving average, seeded by the first sample.

    ``alpha`` is the weight on the NEW sample (1.0 = no smoothing)."""

    alpha: float = 0.3
    value: Optional[float] = None

    def update(self, x: float) -> float:
        x = float(x)
        if self.value is None:
            self.value = x
        else:
            self.value = (1.0 - self.alpha) * self.value + self.alpha * x
        return self.value

    def reset(self) -> None:
        self.value = None
