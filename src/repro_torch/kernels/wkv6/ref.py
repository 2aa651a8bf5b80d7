"""Plain PyTorch version of the WKV6 kernel: the RWKV6 recurrence as a
loop over time in float32 (``repro/kernels/wkv6/ref.py``, in the model's
layout), or in float64 when r is float64 (an exact witness for checks)."""
from __future__ import annotations

import torch


def wkv6_ref(r, k, v, w, u, s0):
    """r/k/w (B, T, H, K), v (B, T, H, V), u (H, K), s0 (B, H, K, V).
    Returns (out (B, T, H, V), sT (B, H, K, V)) in float32 (float64 for
    float64 r)::

        out_t = r_t . (S + u * k_t v_t^T)
        S     = diag(w_t) S + k_t v_t^T
    """
    dt = torch.float64 if r.dtype == torch.float64 else torch.float32
    r, k, v, w = (x.to(dt) for x in (r, k, v, w))
    uu = u.to(dt)[None, :, :, None]  # (1, H, K, 1)
    state = s0.to(dt)
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # (B, H, K, V)
        outs.append(((state + uu * kv) * r[:, t, :, :, None]).sum(dim=2))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(outs, dim=1), state
