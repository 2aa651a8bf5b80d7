"""The yardstick's arithmetic: the card's peaks, each kernel's least time
from its shapes, and the model FLOPs of a scoring pass.

Peaks are the NVIDIA H100 SXM data sheet's dense rates at its 700 W limit.
A kernel's bound is the larger of the bytes it must move over the HBM rate
and the operations it must do over the peak of the units it runs on: every
input byte read once and every output byte written once.  The ``flash_sdpa``
and ``wkv6`` counts are those the port's chip smoke test uses (the ``wkv6``
count as corrected there: the bonus term is per step, not per state
element).

``model_flops_per_sequence`` counts what a scoring pass must multiply for
the tokens that are scored: 2 FLOPs a weight a token for every weight matrix
a token passes through (the unembedding too; the embedding is a gather and
counts nothing), causal attention's 4 D FLOPs a visible key a head (QK^T and
PV), and the RWKV6 time recurrence's 8 hd FLOPs a channel a token
(``launch/dryrun.py``'s ``recurrence_flops``).  It corrects that dry run's
``model_flops``, which counts the embedding table as multiplied and leaves
out attention and the RWKV6 LoRA projections.  Padding is computed by the
program but is not useful work, so only the positions with a label are
counted.  The RWKV6 token-shift LoRA's B is counted as published, one
(r, M) block a stream (``time_maa_w2``, 5 r M weights); the program
multiplies a dense (5 r, 5 M) matrix, five times that, and the excess is
not counted as useful work.  A family with no count here gives None.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

DATA_SHEET = "NVIDIA H100 SXM data sheet (dense, 700 W)"
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12  # CUDA cores
PEAK_BF16_OPS_PER_S = 989e12  # tensor cores


def bound_s(bytes_moved: float, ops: float, peak_ops: float) -> Tuple[float, str]:
    """(seconds, what bounds it): the larger of bytes over the HBM rate and
    operations over ``peak_ops``."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    t_ops = ops / peak_ops
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_sdpa_cost(B: int, S: int, T: int, H: int, K: int, D: int, *, causal: bool = True,
                    q_offset: int = 0, elem_bytes: int = 2) -> Tuple[float, float, float]:
    """(bytes, operations, peak) of one ``flash_sdpa`` call on q (B, S, H, D)
    and k / v (B, T, K, D): q read and out written once, the visible keys and
    values read once; 4 D operations a (query, visible key) pair and head.  A
    causal prefill (S = T) sees S (S + 1) / 2 pairs a head."""
    keys = q_offset + 1 if causal and S == 1 else T
    if causal and S > 1:
        pairs = B * H * S * (S + 1) // 2
    else:
        pairs = B * H * S * keys
    bytes_moved = elem_bytes * (2 * B * S * H * D + 2 * B * keys * K * D)
    peak = PEAK_BF16_OPS_PER_S if elem_bytes == 2 else PEAK_F32_OPS_PER_S
    return float(bytes_moved), float(4 * D * pairs), peak


def wkv6_cost(B: int, T: int, H: int, K: int, V: int, *, x_bytes: int = 2,
              w_bytes: int = 4) -> Tuple[float, float, float]:
    """(bytes, operations, peak) of one ``wkv6`` call: r, k (``x_bytes``), w
    (``w_bytes``), v, u and the initial state read once, out and the final
    state (float32) written once; r.S is one multiply-add a state element,
    the update w S + k v three, and the bonus term 3 K + 2 V a step.  The
    recurrence runs in float32 on the CUDA cores."""
    n = B * T * H
    bytes_moved = (n * K * (2 * x_bytes + w_bytes) + n * V * x_bytes + H * K * 4
                   + 2 * B * H * K * V * 4 + n * V * 4)
    ops = 5 * n * K * V + n * (3 * K + 2 * V)
    return float(bytes_moved), float(ops), PEAK_F32_OPS_PER_S


def _dense_layer_weights(m: Dict) -> int:
    """Weights a token of the dense (Qwen2) stack multiplies in one layer."""
    M, H, K, D = m["d_model"], m["num_heads"], m["num_kv_heads"], m["head_dim"]
    return M * H * D * 2 + M * K * D * 2 + 3 * M * m["d_ff"]


def _rwkv_layer_weights(m: Dict) -> int:
    """Weights a token of the RWKV6 stack multiplies in one layer: the
    token-shift and decay LoRAs, r / k / v / g / o, and the channel mix."""
    M, r, F = m["d_model"], m.get("rwkv_lora_rank", 32), m["d_ff"]
    loras = M * 5 * r + 5 * r * M + M * 2 * r + 2 * r * M
    return loras + 5 * M * M + 2 * M * F + M * M


def _prefix_pairs(n: int) -> int:
    """Keys visible to the first n positions under causal attention."""
    return n * (n + 1) // 2


def model_flops_per_sequence(m: Dict, layers: int, scored: int) -> Optional[float]:
    """FLOPs a pass through ``layers`` layers and the unembedding needs for
    the first ``scored`` positions of one sequence (``m`` the model section
    of a configuration file); None for a family this file does not count."""
    head = 2 * m["d_model"] * m["vocab_size"] * scored
    if m["arch_type"] == "rwkv":
        per_layer = 2 * _rwkv_layer_weights(m) * scored
        recurrence = 8 * m["d_model"] * m["rwkv_head_size"] * scored
        return float(layers * (per_layer + recurrence) + head)
    if m["arch_type"] != "dense":
        return None
    per_layer = 2 * _dense_layer_weights(m) * scored
    attention = 4 * m["head_dim"] * m["num_heads"] * _prefix_pairs(scored)
    return float(layers * (per_layer + attention) + head)


def cascade_flops(m: Dict, exit_layer: int, scored: Sequence[int]) -> Optional[float]:
    """FLOPs of the weak (``exit_layer`` layers) and the strong (every
    layer) pass over the scored positions of each sequence; None for a
    family with no count."""
    if model_flops_per_sequence(m, 1, 1) is None:
        return None
    return sum(model_flops_per_sequence(m, exit_layer, n) + model_flops_per_sequence(
        m, m["num_layers"], n) for n in scored)
