"""Qwen2 dense decoder, plain float32 PyTorch, from the published
architecture (arXiv:2407.10671; the Hugging Face Qwen2 modelling code):
token embedding; per layer RMSNorm -> grouped-query attention with q/k/v
biases and rotary embeddings (rotate-half form, theta ``rope_theta``),
causal softmax at 1/sqrt(D) -> output projection, residual; RMSNorm ->
SwiGLU MLP (silu(x W_gate) * x W_up) W_down, residual; a final RMSNorm and
an untied unembedding.  Departures, to match the configuration as the
program runs it: no sliding window (Qwen2-7B's config disables it), RMSNorm
eps 1e-6.

The weights are read from the parameter tree the benchmark hands both sides
(``layers/<leaf>`` stacked over layers, the program's key names), cast to
float32 one layer at a time.  Every sequence runs at its own length: no
padding reaches the reference.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from reference.common import Matmul, rmsnorm, rope, rows


def embed(params: Dict, tokens: List[np.ndarray]) -> List[torch.Tensor]:
    table = params["embed"]
    return [table[torch.as_tensor(np.asarray(t), dtype=torch.int64, device=table.device)].float()
            for t in tokens]


def unembed(params: Dict) -> torch.Tensor:
    return params["unembed"].float()


def final(params: Dict, m: Dict, h: torch.Tensor) -> torch.Tensor:
    return rmsnorm(h, params["final_norm"]["scale"].float())


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention of one sequence: q (S, H, D), k / v (S, K, D);
    query head h reads key head h // (H / K)."""
    S, H, D = q.shape
    K = k.shape[1]
    G = H // K
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    out = torch.empty_like(q)
    for j in range(K):
        qg = q[:, j * G:(j + 1) * G].transpose(0, 1)  # (G, S, D)
        s = qg @ k[:, j].T / D**0.5  # (G, S, S)
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out[:, j * G:(j + 1) * G] = (p @ v[:, j]).transpose(0, 1)
        del s, p
    return out


def _layer(w: Dict, m: Dict, x: torch.Tensor, lens: List[int], mm: Matmul) -> torch.Tensor:
    H, K, D = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    a = w["attn"]
    xn = rmsnorm(x, w["norm1"]["scale"])
    q = rows(mm, xn, a["wq"]) + a["bq"]
    k = rows(mm, xn, a["wk"]) + a["bk"]
    v = rows(mm, xn, a["wv"]) + a["bv"]
    att, at = [], 0
    for n in lens:
        qs = rope(q[at:at + n].reshape(n, H, D), m["rope_theta"])
        ks = rope(k[at:at + n].reshape(n, K, D), m["rope_theta"])
        att.append(_attention(qs, ks, v[at:at + n].reshape(n, K, D)).reshape(n, H * D))
        at += n
    h = x + rows(mm, torch.cat(att), a["wo"])
    hn = rmsnorm(h, w["norm2"]["scale"])
    p = w["mlp"]
    out = []
    for i in range(0, hn.shape[0], 8192):  # bounds the (rows, d_ff) intermediates
        blk = hn[i:i + 8192]
        out.append(mm(F.silu(mm(blk, p["gate"])) * mm(blk, p["up"]), p["down"]))
    return h + torch.cat(out)


def layers(params: Dict, m: Dict, hs: List[torch.Tensor], lo: int, hi: int,
           mm: Matmul) -> List[torch.Tensor]:
    """Layers lo..hi-1 over every sequence, one layer's weights in float32
    at a time."""
    if not hs or lo >= hi:
        return list(hs)
    lens = [h.shape[0] for h in hs]
    x = torch.cat(hs)
    stack = params["layers"]
    for i in range(lo, hi):
        w = {g: {n: t[i].float() for n, t in leaves.items()} for g, leaves in stack.items()}
        x = _layer(w, m, x, lens, mm)
        del w
    return list(x.split(lens))
