"""Plain PyTorch version of the estimator MLP kernel (2-layer, tanh GELU,
sigmoid head)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def estimator_mlp_ref(x, w1, b1, w2, b2) -> torch.Tensor:
    """x (B,F), w1 (F,H), b1 (H,), w2 (H,), b2 () -> (B,)."""
    h = F.gelu(x @ w1 + b1, approximate="tanh")
    return torch.sigmoid(h @ w2 + b2)
