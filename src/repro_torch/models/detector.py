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

Training (``build_targets``, ``detector_loss``) comes with the port's
training slice.
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
            top, bottom = _same_pad(h.shape[2], 3, 2)
            left, right = _same_pad(h.shape[3], 3, 2)
            h = _gelu(conv_a(F.pad(h, (left, right, top, bottom))))
            h = _gelu(getattr(self, f"stage{i}_b")(h))
        feat = h
        h = _gelu(self.head_hidden(h))
        out = self.head_out(h)
        return out.permute(0, 2, 3, 1), feat.permute(0, 2, 3, 1)


def _images(detector: Detector, images) -> torch.Tensor:
    return torch.as_tensor(images, dtype=torch.float32).to(detector.device)


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
