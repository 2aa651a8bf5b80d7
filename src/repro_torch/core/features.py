"""Estimator input features from the weak detector's output (paper §V-A).

Features of the top-K (default 25) boxes ranked by confidence, concatenated
with global summary statistics.  Per box: ``[score, cx, cy, w, h, area,
aspect, onehot(class)]``; global: ``[num_boxes/K, mean score, max score,
score entropy, class histogram]``.

``extract_features`` is the per-image numpy reference (copied from the JAX
package); ``extract_features_batch`` is one batched pass over a padded
:class:`repro_torch.detection.batch.DetectionsBatch` on its device.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.detection.batch import DetectionsBatch
from repro_torch.detection.map_engine import Detections
from repro_torch.kernels.dispatch import DeviceLike


def feature_dim(num_classes: int, top_k: int = 25) -> int:
    per_box = 7 + num_classes
    global_dim = 4 + num_classes
    return top_k * per_box + global_dim


def extract_features(
    det: Detections,
    num_classes: int,
    top_k: int = 25,
    image_size: float = 1.0,
) -> np.ndarray:
    """Fixed-size feature vector for one image's weak detections."""
    det = det.top_k(top_k)
    n = len(det)
    per_box = 7 + num_classes
    feats = np.zeros((top_k, per_box), dtype=np.float32)
    if n:
        b = det.boxes / image_size
        cx = (b[:, 0] + b[:, 2]) / 2
        cy = (b[:, 1] + b[:, 3]) / 2
        w = np.maximum(b[:, 2] - b[:, 0], 0)
        h = np.maximum(b[:, 3] - b[:, 1], 0)
        area = w * h
        aspect = w / np.maximum(h, 1e-6)
        feats[:n, 0] = det.scores
        feats[:n, 1] = cx
        feats[:n, 2] = cy
        feats[:n, 3] = w
        feats[:n, 4] = h
        feats[:n, 5] = area
        feats[:n, 6] = np.clip(aspect, 0, 10) / 10.0
        cls = np.clip(det.classes, 0, num_classes - 1)
        feats[np.arange(n), 7 + cls] = 1.0
    hist = np.zeros(num_classes, dtype=np.float32)
    if n:
        np.add.at(hist, np.clip(det.classes, 0, num_classes - 1), 1.0)
        hist /= n
        s = det.scores / max(det.scores.sum(), 1e-9)
        entropy = float(-(s * np.log(np.maximum(s, 1e-12))).sum())
        glob = np.array(
            [n / top_k, float(det.scores.mean()), float(det.scores.max()), entropy],
            dtype=np.float32,
        )
    else:
        glob = np.zeros(4, dtype=np.float32)
    return np.concatenate([feats.reshape(-1), glob, hist])


def pad_box_axis(boxes, scores, classes, mask, top_k: int):
    """Pad the box axis to ``top_k`` slots (boxes 0, scores 0, classes -1,
    mask False) when it is shorter: the feature stack reads a fixed top_k
    window."""
    K = scores.shape[1]
    if K >= top_k:
        return boxes, scores, classes, mask
    pad = top_k - K
    return (
        F.pad(boxes, (0, 0, 0, pad)),
        F.pad(scores, (0, pad)),
        F.pad(classes, (0, pad), value=-1),
        F.pad(mask, (0, pad)),
    )


def box_feature_stack(boxes, scores, classes, mask, image_size, num_classes, top_k):
    """Top-k selection + per-box features + global stats, all masked ops
    over the padded (B, K >= top_k) struct-of-arrays; the operations of
    ``repro.core.features.box_feature_stack`` in the same order."""
    # top-k by confidence; invalid slots sink with -inf keys, ties keep the
    # original slot order (stable)
    keys = torch.where(mask, scores, torch.full_like(scores, -torch.inf))
    order = torch.argsort(-keys, dim=1, stable=True)[:, :top_k]  # (B, top_k)
    m = torch.take_along_dim(mask, order, dim=1).to(torch.float32)
    s = torch.take_along_dim(scores, order, dim=1) * m
    cls = torch.take_along_dim(classes, order, dim=1).clamp(0, num_classes - 1)
    size = torch.tensor(image_size, dtype=torch.float32, device=boxes.device)
    b = torch.take_along_dim(boxes, order[:, :, None], dim=1) / size
    cx = (b[..., 0] + b[..., 2]) / 2
    cy = (b[..., 1] + b[..., 3]) / 2
    w = (b[..., 2] - b[..., 0]).clamp(min=0.0)
    h = (b[..., 3] - b[..., 1]).clamp(min=0.0)
    area = w * h
    aspect = (w / h.clamp(min=1e-6)).clamp(0.0, 10.0) / 10.0
    onehot = F.one_hot(cls.long(), num_classes).to(torch.float32) * m[..., None]
    feats = torch.cat(
        [
            torch.stack([s, cx * m, cy * m, w * m, h * m, area * m, aspect * m], dim=-1),
            onehot,
        ],
        dim=-1,
    )  # (B, top_k, 7 + C)

    n = m.sum(dim=1)  # (B,) number of selected valid boxes
    nonempty = n > 0
    safe_n = n.clamp(min=1.0)
    zero = torch.zeros((), dtype=torch.float32, device=boxes.device)
    hist = torch.where(nonempty[:, None], onehot.sum(dim=1) / safe_n[:, None], zero)
    s_sum = s.sum(dim=1)
    p = s / s_sum.clamp(min=1e-9)[:, None]
    entropy = -(p * torch.log(p.clamp(min=1e-12))).sum(dim=1)
    s_max = torch.where(m > 0, s, torch.full_like(s, -torch.inf)).amax(dim=1)
    glob = torch.stack(
        [n / top_k, s_sum / safe_n, torch.where(nonempty, s_max, zero), entropy], dim=-1
    )
    glob = torch.where(nonempty[:, None], glob, zero)
    B = scores.shape[0]
    return torch.cat([feats.reshape(B, -1), glob, hist], dim=1)


def extract_features_batch(
    dets: Union[Sequence[Detections], DetectionsBatch],
    num_classes: int,
    top_k: int = 25,
    image_size: float = 1.0,
    *,
    device: DeviceLike = "cuda",
) -> torch.Tensor:
    """(B, F) float32 feature tensor in one batched pass, on the batch's
    device.  A ragged list of ``Detections`` is padded onto ``device``
    first; a :class:`DetectionsBatch` stays where it is."""
    batch = (
        dets if isinstance(dets, DetectionsBatch)
        else DetectionsBatch.from_list(dets, device=device)
    )
    arrays = pad_box_axis(batch.boxes, batch.scores, batch.classes, batch.mask, top_k)
    return box_feature_stack(*arrays, float(image_size), int(num_classes), int(top_k))
