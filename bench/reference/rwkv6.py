"""RWKV-6 "Finch", plain float32 PyTorch, from the published equations
(arXiv:2404.05892, section 4): per layer a time mix and a channel mix, each
after a LayerNorm and each with a residual.

Time mix: token shift x' = x_{t-1} (0 before the first token); the
data-dependent lerp of x and x' for r, k, v, g and w, mix_base + the LoRA
tanh(x A) B (the paper's ddlerp, with the LoRA read from x as the port's
layer does); r, k, v, g projections; the decay w_t = exp(-exp(d_base +
tanh(x_w A_d) B_d)); per head (size hd) the WKV recurrence

    out_t = r_t . (S_{t-1} + diag(u) k_t^T v_t),   S_t = diag(w_t) S_{t-1} + k_t^T v_t

then a LayerNorm over the channels, times silu(g), and the output
projection.  Channel mix: the token-shifted lerp by one mix vector, then
sigmoid(x_k W_r) * (relu(x_k W_k)^2 W_v).  A final LayerNorm and an untied
unembedding.  Departures from the published Finch block, to match the
model as the program runs it (the configuration file lists them under
``assumed``): no LayerNorm after the embedding (ln0); the output LayerNorm
is over all channels (the paper's GroupNorm takes one group a head); one
mix vector serves the channel mix's k and r; the token-shift LoRA reads x,
not the first lerp; and its B is a dense (5 r, 5 M) matrix, five times the
published (5, r, M) ``time_maa_w2``.

The recurrence is computed in chunks of ``CHUNK`` steps: inside a chunk by
the decay products exp(L_{t-1} - L_j) <= 1 of cumulative log decays (never a
ratio that can overflow), across chunks by the state.  Sequences are padded
on the right to a common length inside the reference (the recurrence and
the token shift only look back, so padding after a sequence changes none
of its positions).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from reference.common import Matmul, layernorm, rows

CHUNK = 16
GROUP_TOKENS = 16384  # padded tokens a group of sequences takes through a layer


def embed(params: Dict, tokens: List[np.ndarray]) -> List[torch.Tensor]:
    table = params["embed"]
    return [table[torch.as_tensor(np.asarray(t), dtype=torch.int64, device=table.device)].float()
            for t in tokens]


def unembed(params: Dict) -> torch.Tensor:
    return params["unembed"].float()


def final(params: Dict, m: Dict, h: torch.Tensor) -> torch.Tensor:
    n = params["final_norm"]
    return layernorm(h, n["scale"].float(), n["bias"].float())


def wkv(r, k, v, logw, u, s0=None):
    """The recurrence over (B, T, H, K) r / k / log-decay, v (B, T, H, V),
    u (H, K), from state s0 (B, H, K, V) (zeros when None).  Returns (out
    (B, T, H, V), final state)."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    C = CHUNK
    pad = -T % C
    if pad:
        r, k, logw = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, logw))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    N = (T + pad) // C
    # (B, H, N, C, K)
    r, k, logw = (t.reshape(B, N, C, H, K).permute(0, 3, 1, 2, 4) for t in (r, k, logw))
    v = v.reshape(B, N, C, H, V).permute(0, 3, 1, 2, 4)
    L = logw.cumsum(dim=3)  # log of the decay from the chunk's start through step t
    Lp = L - logw  # ... through step t - 1
    strict = torch.ones((C, C), dtype=torch.bool, device=r.device).tril(-1)  # j < t
    diff = (Lp[..., :, None, :] - L[..., None, :, :]).masked_fill(~strict[..., None], float("-inf"))
    A = (r[..., :, None, :] * k[..., None, :, :] * diff.exp()).sum(-1)  # (B, H, N, C, C)
    del diff
    out = A @ v + (r * u[None, :, None, None, :] * k).sum(-1, keepdim=True) * v
    rdec = r * Lp.exp()
    kdec = k * (L[..., -1:, :] - L).exp()
    chunk_decay = L[..., -1, :].exp()  # (B, H, N, K)
    S = torch.zeros((B, H, K, V), dtype=r.dtype, device=r.device) if s0 is None else s0
    inter = []
    for n in range(N):
        inter.append(rdec[:, :, n] @ S)
        S = chunk_decay[:, :, n, :, None] * S + kdec[:, :, n].transpose(-1, -2) @ v[:, :, n]
    out = out + torch.stack(inter, dim=2)
    out = out.permute(0, 2, 3, 1, 4).reshape(B, N * C, H, V)[:, :T]
    return out, S


def _shift(x: torch.Tensor) -> torch.Tensor:
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _layer(w: Dict, m: Dict, h: torch.Tensor, mm: Matmul) -> torch.Tensor:
    """One layer over a padded group h (B, T, M)."""
    B, T, M = h.shape
    hd = m["rwkv_head_size"]
    H = M // hd
    tm = w["tm"]
    flat = lambda t: t.reshape(B * T, -1)  # noqa: E731
    x = layernorm(h, w["ln1"]["scale"], w["ln1"]["bias"])
    dx = _shift(x) - x
    lora = rows(mm, torch.tanh(rows(mm, flat(x), tm["mix_lora_a"])), tm["mix_lora_b"])
    mixed = x[:, :, None, :] + dx[:, :, None, :] * (tm["mix_base"] + lora.reshape(B, T, 5, M))
    xr, xk, xv, xg, xw = (flat(t) for t in mixed.unbind(dim=2))
    del mixed, lora
    r = rows(mm, xr, tm["wr"]).reshape(B, T, H, hd)
    k = rows(mm, xk, tm["wk"]).reshape(B, T, H, hd)
    v = rows(mm, xv, tm["wv"]).reshape(B, T, H, hd)
    g = F.silu(rows(mm, xg, tm["wg"]))
    d = tm["decay_base"] + rows(mm, torch.tanh(rows(mm, xw, tm["decay_lora_a"])), tm["decay_lora_b"])
    logw = -torch.exp(d).reshape(B, T, H, hd)
    out, _ = wkv(r, k, v, logw, tm["bonus"])
    out = layernorm(out.reshape(B * T, M), tm["ln_x"]["scale"], tm["ln_x"]["bias"]) * g
    h = h + rows(mm, out, tm["wo"]).reshape(B, T, M)
    x2 = layernorm(h, w["ln2"]["scale"], w["ln2"]["bias"])
    xk2 = flat(x2 + (_shift(x2) - x2) * tm["cm_mix"])
    kk = torch.square(F.relu(rows(mm, xk2, tm["cm_k"])))
    cm = torch.sigmoid(rows(mm, xk2, tm["cm_r"])) * rows(mm, kk, tm["cm_v"])
    return h + cm.reshape(B, T, M)


def _groups(lens: List[int]) -> List[List[int]]:
    """Indices of sequences in groups of at most GROUP_TOKENS padded tokens
    (longest first, so a group pads little)."""
    order = sorted(range(len(lens)), key=lambda i: -lens[i])
    groups, cur = [], []
    for i in order:
        if cur and (len(cur) + 1) * lens[cur[0]] > GROUP_TOKENS:
            groups.append(cur)
            cur = []
        cur.append(i)
    return groups + [cur] if cur else groups


def layers(params: Dict, m: Dict, hs: List[torch.Tensor], lo: int, hi: int,
           mm: Matmul) -> List[torch.Tensor]:
    """Layers lo..hi-1 over every sequence, one layer's weights in float32
    at a time, sequences in padded groups."""
    if not hs or lo >= hi:
        return list(hs)
    lens = [h.shape[0] for h in hs]
    groups = _groups(lens)
    padded = []
    for g in groups:
        T = lens[g[0]]
        padded.append(torch.stack([F.pad(hs[i], (0, 0, 0, T - lens[i])) for i in g]))
    stack = params["layers"]
    for li in range(lo, hi):
        w = {}
        for grp, leaves in stack.items():
            w[grp] = {}
            for n, t in leaves.items():
                w[grp][n] = ({kk: tt[li].float() for kk, tt in t.items()} if isinstance(t, dict)
                             else t[li].float())
        padded = [_layer(w, m, x, mm) for x in padded]
        del w
    out = [None] * len(hs)
    for g, x in zip(groups, padded):
        for j, i in enumerate(g):
            out[i] = x[j, :lens[i]]
    return out
