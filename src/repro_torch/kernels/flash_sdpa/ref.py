"""Plain PyTorch version of the flash SDPA kernel: masked softmax attention
in float32 over the model's layout, fully masked rows giving 0 (the
semantics of ``repro/kernels/flash_sdpa/ref.py``, with GQA read by head
grouping instead of repeated K/V)."""
from __future__ import annotations

import torch


def sdpa_mask(S: int, T: int, causal: bool, window: int, q_offset: int,
              device=None) -> torch.Tensor:
    """(S, T) bool: query i (position ``q_offset + i``) sees key j iff
    ``j <= q_offset + i`` (causal) and ``j > q_offset + i - window``
    (``window > 0``)."""
    qpos = q_offset + torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def flash_sdpa_ref(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, K, D), H % K == 0
    v: torch.Tensor,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    """Returns (B, S, H, D) in q's dtype."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qf = q.float().reshape(B, S, K, G, D)
    s = torch.einsum("bskgd,btkd->bkgst", qf, k.float()) / (D ** 0.5)
    mask = sdpa_mask(S, T, causal, window, q_offset, device=q.device)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)  # fully masked rows
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)
