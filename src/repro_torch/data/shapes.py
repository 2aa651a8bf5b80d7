"""Procedural object-detection dataset: coloured shapes on textured noise.

COCO/VOC are unavailable offline, so the detection repro trains on this
generator.  8 classes = {rectangle, ellipse, triangle, cross} × {warm,
cool} colour families; 1–6 objects per 64×64 image, sizes 10–30 px, mild
occlusion, per-object colour jitter, background = low-frequency noise.
Ground truth boxes are exact.  The generator is deterministic in its seed
(train/val splits use disjoint seed streams).

Copied from the JAX package (``repro.data.shapes``); plain numpy, so both
packages draw the same images and ground truth from one seed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.detection.map_engine import GroundTruth

NUM_CLASSES = 8
IMAGE_SIZE = 64
CLASS_NAMES = [
    "rect_warm", "rect_cool", "ellipse_warm", "ellipse_cool",
    "tri_warm", "tri_cool", "cross_warm", "cross_cool",
]

_WARM = np.array([[0.9, 0.3, 0.2], [0.95, 0.6, 0.1], [0.85, 0.2, 0.5]])
_COOL = np.array([[0.2, 0.4, 0.9], [0.1, 0.8, 0.7], [0.4, 0.2, 0.85]])


def _background(rng: np.random.Generator, size: int) -> np.ndarray:
    base = rng.uniform(0.1, 0.45, (1, 1, 3))
    lowfreq = rng.normal(0, 1, (size // 8, size // 8, 3))
    lowfreq = np.kron(lowfreq, np.ones((8, 8, 1)))
    noise = rng.normal(0, 0.02, (size, size, 3))
    img = base + 0.05 * lowfreq + noise
    return np.clip(img, 0, 1).astype(np.float32)


def _shape_mask(kind: int, h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = (h - 1) / 2, (w - 1) / 2
    if kind == 0:  # rectangle
        return np.ones((h, w), dtype=bool)
    if kind == 1:  # ellipse
        return ((yy - cy) / (h / 2)) ** 2 + ((xx - cx) / (w / 2)) ** 2 <= 1.0
    if kind == 2:  # triangle (apex up)
        frac = yy / max(h - 1, 1)
        half = frac * (w / 2)
        return np.abs(xx - cx) <= half
    # cross
    tw = max(w // 3, 2)
    th = max(h // 3, 2)
    return (np.abs(xx - cx) <= tw / 2) | (np.abs(yy - cy) <= th / 2)


def paint_object(
    img: np.ndarray,
    box: Sequence[float],
    cls: int,
    colour: np.ndarray,
    rng: np.random.Generator,
) -> None:
    """Draw one shape (class ``cls = kind * 2 + warm``) into ``img`` in
    place, clipped to the image bounds.  Shared by the static generator and
    the video scene renderer of the JAX package."""
    size = img.shape[0]
    x1, y1 = max(int(round(box[0])), 0), max(int(round(box[1])), 0)
    x2, y2 = min(int(round(box[2])), size), min(int(round(box[3])), size)
    w, h = x2 - x1, y2 - y1
    if w <= 0 or h <= 0:
        return
    mask = _shape_mask(int(cls) // 2, h, w, rng)
    patch = img[y1:y2, x1:x2]
    patch[mask] = np.clip(colour, 0, 1)
    img[y1:y2, x1:x2] = patch


def class_colour(cls: int, rng: np.random.Generator) -> np.ndarray:
    """A jittered colour sample from the class's warm/cool palette."""
    palette = _WARM if int(cls) % 2 == 0 else _COOL
    return palette[rng.integers(0, len(palette))] + rng.normal(0, 0.05, 3)


def render_image(
    rng: np.random.Generator, size: int = IMAGE_SIZE, max_objects: int = 6
) -> Tuple[np.ndarray, GroundTruth]:
    """One image + exact ground truth."""
    img = _background(rng, size)
    n = int(rng.integers(1, max_objects + 1))
    boxes: List[List[float]] = []
    classes: List[int] = []
    for _ in range(n):
        kind = int(rng.integers(0, 4))
        warm = int(rng.integers(0, 2))
        cls = kind * 2 + warm
        w = int(rng.integers(10, 31))
        h = int(rng.integers(10, 31))
        x1 = int(rng.integers(0, size - w))
        y1 = int(rng.integers(0, size - h))
        paint_object(img, [x1, y1, x1 + w, y1 + h], cls, class_colour(cls, rng), rng)
        boxes.append([x1, y1, x1 + w, y1 + h])
        classes.append(cls)
    gt = GroundTruth(np.array(boxes, dtype=np.float64), np.array(classes))
    return img, gt


@dataclass
class ShapesDataset:
    """Materialised split of the procedural dataset."""

    images: np.ndarray  # (N, S, S, 3) float32
    gts: List[GroundTruth]

    @classmethod
    def generate(
        cls, n: int, seed: int, size: int = IMAGE_SIZE, max_objects: int = 6
    ) -> "ShapesDataset":
        rng = np.random.default_rng(seed)
        imgs, gts = [], []
        for _ in range(n):
            img, gt = render_image(rng, size, max_objects)
            imgs.append(img)
            gts.append(gt)
        return cls(np.stack(imgs), gts)

    def __len__(self) -> int:
        return self.images.shape[0]

    def batches(self, batch_size: int, rng: np.random.Generator):
        """Yield (images, target arrays) minibatches, shuffled; targets are
        padded to ``max_objects`` with class -1."""
        n = len(self)
        perm = rng.permutation(n)
        max_obj = max(len(g) for g in self.gts)
        for s in range(0, n - batch_size + 1, batch_size):
            idx = perm[s : s + batch_size]
            imgs = self.images[idx]
            boxes = np.zeros((batch_size, max_obj, 4), dtype=np.float32)
            classes = np.full((batch_size, max_obj), -1, dtype=np.int32)
            for bi, i in enumerate(idx):
                g = self.gts[i]
                m = len(g)
                boxes[bi, :m] = g.boxes
                classes[bi, :m] = g.classes
            yield imgs, boxes, classes
