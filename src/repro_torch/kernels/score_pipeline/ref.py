"""Plain PyTorch version of the fused serve-time score pipeline: top-k box
features, standardize, 2-layer sigmoid MLP — the composed serve path as one
function, as ``repro.kernels.score_pipeline.ref.score_pipeline_ref``."""
from __future__ import annotations

import torch

from repro_torch.core.features import box_feature_stack, pad_box_axis
from repro_torch.kernels.estimator_mlp.ref import estimator_mlp_ref


def score_pipeline_ref(
    boxes,  # (B, K, 4) padded detector boxes
    scores,  # (B, K)
    classes,  # (B, K) int32, padded slots -1
    mask,  # (B, K) bool
    w1,  # (F, H)
    b1,  # (H,)
    w2,  # (H,)
    b2,  # ()
    mu,  # (F,) standardize mean (zeros when standardize is off)
    sigma,  # (F,) standardize scale (ones when standardize is off)
    image_size: float,
    num_classes: int,
    top_k: int,
) -> torch.Tensor:
    """(B,) reward estimates straight from padded detection arrays."""
    arrays = pad_box_axis(boxes, scores, classes, mask, top_k)
    f = box_feature_stack(*arrays, image_size, num_classes, top_k)
    x = (f - mu) / sigma
    return estimator_mlp_ref(x, w1, b1, w2, b2)
