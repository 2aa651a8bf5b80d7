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


LOG2E = 1.4426950408889634


def _group_rows(x: torch.Tensor, K: int) -> torch.Tensor:
    """(B, S, H, D) -> (B, K, S G, D): row s G + g of KV head kv is query s
    of head kv G + g (the decode route's row order)."""
    B, S, H, D = x.shape
    return x.reshape(B, S, K, H // K, D).permute(0, 2, 1, 3, 4).reshape(B, K, S * (H // K), D)


def decode_partials_ref(q, k, v, plan, causal: bool = True, window: int = 0,
                        q_offset: int = 0):
    """The decode route's splits as plain PyTorch: for ``plan`` (a
    ``flash_sdpa.ops.DecodePlan``) returns (acc (B, K, splits, rows, D),
    ml (B, K, splits, rows, 2)) in float32 (float64 for float64 q): each
    split's running max m of the scores in the log2 domain (log2(e) / sqrt(D)
    q.k; -inf when the split sees no key for the row), its denominator
    l = sum 2^(x - m) and its unnormalised output acc = sum 2^(x - m) v."""
    dt = torch.float64 if q.dtype == torch.float64 else torch.float32
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    x = torch.einsum("bkrd,btkd->bkrt", _group_rows(q.to(dt), K), k.to(dt)) * (LOG2E / D ** 0.5)
    mask = sdpa_mask(S, T, causal, window, q_offset, device=q.device).repeat_interleave(G, dim=0)
    x = x.masked_fill(~mask, float("-inf"))
    span = plan.tiles_per_split * 32
    accs, mls = [], []
    for i in range(plan.splits):
        lo = plan.kbeg + i * span
        hi = max(lo, min(plan.kend, lo + span))
        xs = x[..., lo:hi]
        m = xs.amax(dim=-1) if hi > lo else torch.full(x.shape[:-1], float("-inf"), dtype=dt,
                                                       device=q.device)
        m_safe = torch.where(m == float("-inf"), torch.zeros_like(m), m)
        p = torch.exp2(xs - m_safe[..., None])
        accs.append(torch.einsum("bkrt,btkd->bkrd", p, v[:, lo:hi].to(dt)))
        mls.append(torch.stack([m, p.sum(dim=-1)], dim=-1))
    return torch.stack(accs, dim=2), torch.stack(mls, dim=2)


def merge_partials_ref(acc: torch.Tensor, ml: torch.Tensor, S: int) -> torch.Tensor:
    """The decode route's merge as plain PyTorch: splits (B, K, splits, rows,
    D) and (B, K, splits, rows, 2) -> (B, S, H, D), by the log-sum-exp rule
    (log2 domain); a row that no split sees gives 0."""
    B, K, _, R, D = acc.shape
    m, l = ml[..., 0], ml[..., 1]
    top = m.amax(dim=2, keepdim=True)
    top = torch.where(top == float("-inf"), torch.zeros_like(top), top)
    w = torch.where(m == float("-inf"), torch.zeros_like(m), torch.exp2(m - top))
    den = (w * l).sum(dim=2).clamp_min(1e-30)
    out = (w[..., None] * acc).sum(dim=2) / den[..., None]  # (B, K, R, D)
    G = R // S
    return out.reshape(B, K, S, G, D).permute(0, 2, 1, 3, 4).reshape(B, S, K * G, D)
