"""Plain float32 PyTorch pieces the references share: norms, rotary
embeddings, the logit statistics of a scoring head, the reward head and the
threshold policy.  Nothing here imports the program.

Every matrix product goes through a ``matmul`` argument: ``exact`` (float32,
with TF32 off inside :func:`float32_exact`), or ``fp8`` (both operands
rounded to float8 e4m3 with a per-tensor scale, then multiplied in float32),
the lower precision that the control runs in.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
FP8_MAX = 448.0  # largest float8 e4m3 value


def exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def fp8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _fp8(a) @ _fp8(b)


MATMULS: Dict[str, Matmul] = {"exact": exact, "fp8": fp8}


@contextlib.contextmanager
def float32_exact():
    """TF32 off for matrix products and convolutions, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def rows(mm: Matmul, x: torch.Tensor, w: torch.Tensor, block: int = 8192) -> torch.Tensor:
    """``mm(x, w)`` over blocks of ``x``'s rows (x 2-D).  The fp8 scale is
    per block, as a kernel that quantizes a tile of tokens would take it."""
    if x.shape[0] <= block:
        return mm(x, w)
    return torch.cat([mm(x[i:i + block], w) for i in range(0, x.shape[0], block)])


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, D) rotated at positions 0..S-1, the two halves of each head
    as the (real, imaginary) parts, frequencies theta^(-2 i / D)."""
    S, _, D = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def head_stats(hn: torch.Tensor, unembed: torch.Tensor, labels: np.ndarray, top_k: int,
               mm: Matmul, block: int = 1024) -> Dict[str, float]:
    """One sequence's scoring statistics from its normalized final hidden
    states ``hn`` (n, M): the mean next-token NLL over the labelled
    positions, and the reward features: mean and largest entropy, mean
    margin of the two most likely tokens, mean largest probability, mean of
    each of the ``top_k`` largest probabilities (positions without a label
    count 0 towards the largest entropy, as in the program's definition)."""
    lab = torch.as_tensor(np.asarray(labels), dtype=torch.int64, device=hn.device)
    valid = (lab >= 0).float()
    ent, topv, nll = [], [], []
    for i in range(0, hn.shape[0], block):
        lf = torch.log_softmax(rows(mm, hn[i:i + block], unembed), dim=-1)
        p = lf.exp()
        ent.append(-(p * lf).sum(-1))
        topv.append(torch.topk(p, top_k, dim=-1).values)
        gold = lab[i:i + block].clamp(min=0)
        nll.append(-lf.gather(-1, gold[:, None])[:, 0])
        del lf, p
    ent, topv, nll = torch.cat(ent), torch.cat(topv), torch.cat(nll)
    n = valid.sum().clamp(min=1)
    mean = lambda t: float((t * valid).sum() / n)  # noqa: E731
    feats = [mean(ent), float((ent * valid).max()), mean(topv[:, 0] - topv[:, 1]),
             mean(topv[:, 0])] + [mean(topv[:, j]) for j in range(top_k)]
    return {"nll": mean(nll), "features": feats}


def mlp(x: np.ndarray, head: Dict[str, np.ndarray]) -> np.ndarray:
    """The reward head in float64: tanh GELU hidden layer, sigmoid out."""
    h = x @ head["w1"] + head["b1"]
    h = 0.5 * h * (1.0 + np.tanh(np.sqrt(2.0 / np.pi) * (h + 0.044715 * h**3)))
    return 1.0 / (1.0 + np.exp(-(h @ head["w2"] + head["b2"])))


def standardizer(cal: np.ndarray, floor: float):
    """(mu, sigma) of calibration features: the mean, and the population
    std, but no less than ``floor`` times |mean|, plus 1e-6.  A feature that
    varies across requests by less than the served dtype resolves of its
    size would otherwise have rounding decide the estimate."""
    mu = cal.mean(axis=0)
    return mu, np.maximum(cal.std(axis=0), floor * np.abs(mu)) + 1e-6


def threshold(scores: Sequence[float], ratio: float) -> float:
    """The quantile threshold that offloads a ``ratio`` share: offload
    iff estimate > the (1 - ratio) quantile of the calibration scores."""
    return float(np.quantile(np.sort(np.asarray(scores, np.float64)), 1.0 - ratio))


def decisions(cal: np.ndarray, sample: np.ndarray, head: Dict[str, np.ndarray],
              ratio: float, floor: float) -> Dict[str, np.ndarray]:
    """The decision stack calibrated on ``cal`` features (standardised with
    ``floor``), applied to ``sample``: estimates, threshold and offload
    mask."""
    mu, sigma = standardizer(cal, floor)
    thr = threshold(mlp((cal - mu) / sigma, head), ratio)
    est = mlp((sample - mu) / sigma, head)
    return {"estimates": est, "threshold": thr, "offload": est > thr}


def score(family, params: Dict, m: Dict, exit_layer: int, cal: List, sample: List,
          top_k: int, mm: Matmul) -> Dict:
    """Run a family's reference over calibration sequences (weak pass only)
    and sampled sequences (weak and strong).  Each sequence is (tokens,
    labels) of its own length, unpadded.  Returns the calibration features
    and, for the samples, features, weak NLL and strong NLL."""
    seqs = list(cal) + list(sample)
    hs = family.embed(params, [t for t, _ in seqs])
    hs = family.layers(params, m, hs, 0, exit_layer, mm)
    weak = [head_stats(family.final(params, m, h), family.unembed(params), lab, top_k, mm)
            for h, (_, lab) in zip(hs, seqs)]
    tail = family.layers(params, m, hs[len(cal):], exit_layer, m["num_layers"], mm)
    strong = [head_stats(family.final(params, m, h), family.unembed(params), lab, top_k, mm)
              for h, (_, lab) in zip(tail, sample)]
    nc = len(cal)
    return {
        "cal_features": np.array([w["features"] for w in weak[:nc]], np.float64).reshape(nc, -1),
        "features": np.array([w["features"] for w in weak[nc:]], np.float64),
        "nll_weak": np.array([w["nll"] for w in weak[nc:]]),
        "nll_strong": np.array([s["nll"] for s in strong]),
    }
