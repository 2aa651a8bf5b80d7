"""Single-stage grid detector (YOLOv1/FCOS-lite hybrid) as an ``nn.Module``.

The weak/strong pair of the paper (YOLOv5n / YOLOv5m) is a narrow vs wide
instance of this model.  Per grid cell the head predicts an objectness
logit, C class logits and a box (sigmoid cx, cy offset within the cell;
sigmoid w, h as image fraction).

Parity with ``repro.models.detector``:

* Parameters keep the JAX names (``stage{i}_a/b``, ``head_hidden``,
  ``head_out``); ``repro_torch.convert.detector_params_from_jax`` carries a
  JAX pytree over (HWIO -> OIHW).
* ``padding="SAME"`` with stride 2 is asymmetric in JAX: for an even input
  and a 3x3 kernel it pads 0 before and 1 after.  The stride-2 convs pad
  explicitly by JAX's rule and then run unpadded; ``Conv2d(padding=1)`` would
  shift the sampling grid by one pixel.
* GELU is the tanh approximation, as ``jax.nn.gelu``.
* Images and head outputs are NHWC at the public functions.

Training: ``build_targets`` is a host numpy copy of ``repro``'s (bit-equal)
and ``detector_loss`` the same loss on the module's own (autograd) forward;
``detector_apply`` / ``detector_forward`` are inference only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.detection.batch import DetectionsBatch
from repro_torch.detection.map_engine import Detections
from repro_torch.detection.nms import nms_batch
from repro_torch.kernels.dispatch import DeviceLike, resolve_device


@dataclass(frozen=True)
class DetectorConfig:
    name: str
    widths: Tuple[int, ...]  # conv channels; len = #stride-2 stages
    head_width: int
    num_classes: int = 8
    image_size: int = 64

    @property
    def grid(self) -> int:
        return self.image_size // (2 ** len(self.widths))


WEAK = DetectorConfig("weak", widths=(12, 24, 48), head_width=48)
STRONG = DetectorConfig("strong", widths=(32, 64, 128), head_width=192)


def _same_pad(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``padding="SAME"``: (before, after) so the output is
    ceil(n / stride), with the odd pixel after."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def conv2d_same(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, stride: int) -> torch.Tensor:
    """``lax.conv_general_dilated(..., padding="SAME")`` on NCHW ``x`` and an
    OIHW ``weight``: pad by XLA's rule, then convolve unpadded."""
    k = weight.shape[-1]
    top, bottom = _same_pad(x.shape[2], k, stride)
    left, right = _same_pad(x.shape[3], k, stride)
    return F.conv2d(F.pad(x, (left, right, top, bottom)), weight, bias, stride=stride)


class Detector(nn.Module):
    """The grid detector of ``cfg``; weights are He-normal draws from
    ``generator`` (on the CPU, then moved to ``device``) until a state dict is
    loaded."""

    def __init__(
        self,
        cfg: DetectorConfig,
        *,
        device: DeviceLike = "cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.cfg = cfg
        cin = 3
        for i, w in enumerate(cfg.widths):
            setattr(self, f"stage{i}_a", nn.Conv2d(cin, w, 3, stride=2))
            setattr(self, f"stage{i}_b", nn.Conv2d(w, w, 3, padding=1))
            cin = w
        self.head_hidden = nn.Conv2d(cin, cfg.head_width, 1)
        self.head_out = nn.Conv2d(cfg.head_width, 1 + cfg.num_classes + 4, 1)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        with torch.no_grad():
            for conv in self.children():
                k, cin_ = conv.kernel_size[0], conv.in_channels
                conv.weight.copy_(
                    torch.randn(conv.weight.shape, generator=gen) * float(np.sqrt(2.0 / (k * k * cin_)))
                )
                conv.bias.zero_()
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.head_out.weight.device

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """images (B, S, S, 3) -> raw head (B, G, G, 1 + C + 4) and the
        backbone feature map (B, G, G, widths[-1]), both NHWC."""
        h = images.permute(0, 3, 1, 2)
        for i in range(len(self.cfg.widths)):
            conv_a = getattr(self, f"stage{i}_a")
            h = _gelu(conv2d_same(h, conv_a.weight, conv_a.bias, 2))
            h = _gelu(getattr(self, f"stage{i}_b")(h))
        feat = h
        h = _gelu(self.head_hidden(h))
        out = self.head_out(h)
        return out.permute(0, 2, 3, 1), feat.permute(0, 2, 3, 1)


def _images(detector: Detector, images) -> torch.Tensor:
    return torch.as_tensor(images, dtype=torch.float32).to(detector.device)


def build_targets(
    cfg: DetectorConfig, boxes: np.ndarray, classes: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side target assignment for a padded batch (copied from the JAX
    package): boxes (B, M, 4) pixels, classes (B, M) with -1 padding ->
    obj (B, G, G), cls (B, G, G) int32, box (B, G, G, 4) normalized targets.
    Each object goes to the cell of its centre; a larger object overwrites a
    smaller one in the same cell."""
    B, M, _ = boxes.shape
    G = cfg.grid
    cell = cfg.image_size / G
    obj = np.zeros((B, G, G), dtype=np.float32)
    cls_t = np.zeros((B, G, G), dtype=np.int32)
    box_t = np.zeros((B, G, G, 4), dtype=np.float32)
    area = np.clip(boxes[..., 2] - boxes[..., 0], 0, None) * np.clip(
        boxes[..., 3] - boxes[..., 1], 0, None
    )
    order = np.argsort(area, axis=1)  # small first so large overwrite
    for b in range(B):
        for m in order[b]:
            if classes[b, m] < 0:
                continue
            x1, y1, x2, y2 = boxes[b, m]
            cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
            gx = min(int(cx / cell), G - 1)
            gy = min(int(cy / cell), G - 1)
            obj[b, gy, gx] = 1.0
            cls_t[b, gy, gx] = classes[b, m]
            box_t[b, gy, gx] = [
                cx / cell - gx,  # offset in cell, (0,1)
                cy / cell - gy,
                (x2 - x1) / cfg.image_size,  # size as image fraction
                (y2 - y1) / cfg.image_size,
            ]
    return obj, cls_t, box_t


def detector_loss(detector: Detector, images, obj_t, cls_t, box_t) -> torch.Tensor:
    """``repro.models.detector.detector_loss`` on the module's forward, with
    autograd: objectness BCE (positive cells weighted 5), class CE on
    positive cells, smooth-L1 on the sigmoid boxes of positive cells (x2).
    Targets are host arrays or tensors, moved to the detector's device."""
    cfg = detector.cfg
    dev = detector.device
    obj_t = torch.as_tensor(obj_t, dtype=torch.float32).to(dev)
    cls_t = torch.as_tensor(cls_t).to(dev, torch.int64)
    box_t = torch.as_tensor(box_t, dtype=torch.float32).to(dev)
    out, _ = detector(_images(detector, images))
    obj_logit = out[..., 0]
    cls_logit = out[..., 1 : 1 + cfg.num_classes]
    box_raw = out[..., 1 + cfg.num_classes :]
    # torch.maximum splits the gradient at a tie as jnp.maximum does
    # (relu / clamp_min give it all to one side)
    obj_bce = torch.maximum(obj_logit, torch.zeros_like(obj_logit)) - obj_logit * obj_t + torch.log1p(
        torch.exp(-torch.abs(obj_logit))
    )
    w_pos = 5.0
    obj_loss = torch.mean(obj_bce * torch.where(obj_t > 0, w_pos, 1.0))
    logp = F.log_softmax(cls_logit, dim=-1)
    ce = -torch.gather(logp, -1, cls_t[..., None])[..., 0]
    n_pos = torch.clamp(torch.sum(obj_t), min=1.0)
    cls_loss = torch.sum(ce * obj_t) / n_pos
    box_pred = torch.sigmoid(box_raw)
    diff = torch.abs(box_pred - box_t)
    sl1 = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5).sum(-1)
    box_loss = torch.sum(sl1 * obj_t) / n_pos
    return obj_loss + cls_loss + 2.0 * box_loss


@torch.no_grad()
def detector_apply(detector: Detector, images) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw head and feature map for host or device NHWC images."""
    return detector(_images(detector, images))


@torch.no_grad()
def detector_forward(detector: Detector, images):
    """Decoded (boxes_px (B, G*G, 4), scores (B, G*G), classes (B, G*G)
    int32, feature map), on the detector's device."""
    cfg = detector.cfg
    out, feat = detector(_images(detector, images))
    B = out.shape[0]
    G = cfg.grid
    cell = cfg.image_size / G
    obj = torch.sigmoid(out[..., 0])
    cls_prob = torch.softmax(out[..., 1 : 1 + cfg.num_classes], dim=-1)
    box = torch.sigmoid(out[..., 1 + cfg.num_classes :])
    ar = torch.arange(G, device=out.device)
    gy, gx = torch.meshgrid(ar, ar, indexing="ij")  # as jnp.mgrid[0:G, 0:G]
    cx = (box[..., 0] + gx) * cell
    cy = (box[..., 1] + gy) * cell
    w = box[..., 2] * cfg.image_size
    h = box[..., 3] * cfg.image_size
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
    score = obj * cls_prob.amax(dim=-1)
    cls = cls_prob.argmax(dim=-1).to(torch.int32)  # first max, as jnp.argmax
    return (
        boxes.reshape(B, G * G, 4),
        score.reshape(B, G * G),
        cls.reshape(B, G * G),
        feat,
    )


@torch.no_grad()
def decode_detections(
    detector: Detector,
    images,
    score_threshold: float = 0.25,
    nms_iou: float = 0.45,
    batch_size: int = 256,
) -> List[Detections]:
    """Full inference to a host ``Detections`` list: forward + NMS of each
    image, as ``repro.models.detector.decode_detections``.  NMS runs once
    per chunk, over all its images, and the kept boxes are compacted on the
    host."""
    results: List[Detections] = []
    for s in range(0, len(images), batch_size):
        boxes, scores, classes, _ = detector_forward(detector, images[s : s + batch_size])
        keep = nms_batch(
            boxes, scores, classes, iou_threshold=nms_iou, score_threshold=score_threshold
        )
        boxes, scores, classes, keep = (t.cpu().numpy() for t in (boxes, scores, classes, keep))
        for b in range(boxes.shape[0]):
            results.append(
                Detections(boxes[b][keep[b]], scores[b][keep[b]], classes[b][keep[b]])
            )
    return results


@torch.no_grad()
def decode_batch(
    detector: Detector,
    images,
    score_threshold: float = 0.25,
    nms_iou: float = 0.45,
) -> DetectionsBatch:
    """Full inference that stays on the detector's device: every grid slot
    is kept and the NMS keep mask becomes the batch's ``mask``.  Features,
    matches and decisions equal those of ``DetectionsBatch.from_list`` over
    :func:`decode_detections`, which keeps the same slots in the same
    order."""
    boxes, scores, classes, _ = detector_forward(detector, images)
    keep = nms_batch(
        boxes, scores, classes, iou_threshold=nms_iou, score_threshold=score_threshold
    )
    return DetectionsBatch(boxes=boxes, scores=scores, classes=classes, mask=keep)
