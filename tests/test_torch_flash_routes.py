"""flash_sdpa's routes on the card, checked where they can be on the CPU:
which kernel each (dtype, S, D, G) takes, the decode route's split plan and
scratch, the wrapper's refusals, the split-K merge as plain PyTorch against
``flash_sdpa_ref`` and against ``repro``'s flash kernel (Pallas interpret
mode, as ``tests/test_kernels.py`` runs it), and the bound on the tensor-core
route's rounding of P to bf16 that the card tests' tolerance rests on."""
import math

import numpy as np
import pytest
import torch

import repro.detection.batch  # noqa: F401  (first: repro's kernels import it back)
import jax.numpy as jnp
from repro.kernels.flash_sdpa import flash_sdpa as j_flash_sdpa

from repro_torch.kernels.flash_sdpa import flash_sdpa, flash_sdpa_ref
from repro_torch.kernels.flash_sdpa.ops import (
    DECODE_MAX_ROWS,
    DecodePlan,
    decode_plan,
    flash_route,
)
from repro_torch.kernels.flash_sdpa.ref import decode_partials_ref, merge_partials_ref

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,S,D,G,route", [
    (BF16, 512, 128, 7, "wgmma"),  # qwen2-7b prefill
    (BF16, 1, 128, 7, "decode"),  # qwen2-7b decode step
    (BF16, 7, 128, 7, "decode"),  # S = G: still one CTA a group
    (BF16, 8, 128, 7, "wgmma"),  # S > G
    (BF16, 1, 64, 1, "decode"),  # MHA decode
    (BF16, 2, 64, 1, "wgmma"),
    (BF16, 8, 64, 8, "decode"),  # S G = 64 rows, the most a decode CTA holds
    (BF16, 9, 64, 16, "wgmma"),  # S <= G but S G = 144 rows
    (BF16, 1, 32, 7, "simt"),  # D = 32 stays on the CUDA-core kernel
    (BF16, 512, 32, 2, "simt"),
    (F32, 512, 128, 7, "simt"),  # float32 stays, at every S
    (F32, 1, 128, 7, "simt"),
    (F32, 1, 64, 1, "simt"),
    (BF16, 512, 128, 6, "wgmma"),  # qwen2-vl-2b prefill (12 query heads over 2)
    (BF16, 1, 128, 6, "decode"),  # qwen2-vl-2b decode step
    (BF16, 512, 80, 1, "wgmma"),  # zamba2-2.7b prefill (32 / 32 heads of 80)
    (BF16, 1, 80, 1, "decode"),  # zamba2-2.7b decode step
    (F32, 512, 80, 1, "simt"),
    (F32, 1, 80, 1, "simt"),
])
def test_flash_route(dtype, S, D, G, route):
    assert flash_route(dtype, S, D, G) == route


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("D,takes", [(80, True), (96, False), (48, False), (256, False)])
def test_head_dims_the_wrapper_takes(dtype, D, takes):
    """D = 80 passes _check in both types (on the CPU: the plain version,
    equal to flash_sdpa_ref); an unsupported head dim still raises, with no
    fallback on either device."""
    rng = np.random.default_rng(D)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)).to(dtype)
               for s in ((1, 5, 4, D), (1, 5, 2, D), (1, 5, 2, D)))
    if takes:
        assert torch.equal(flash_sdpa(q, k, v), flash_sdpa_ref(q, k, v))
    else:
        with pytest.raises(ValueError, match=f"head_dim {D} not supported"):
            flash_sdpa(q, k, v)


def test_decode_plan_qwen2_7b():
    """A decode step at position 512 of qwen2-7b's 528-slot cache: 513 keys
    in 17 tiles, 9 splits of 2 tiles, 288 CTAs >= twice the H100's 132 SMs."""
    p = decode_plan(B=8, S=1, T=528, H=28, K=4, D=128, q_offset=512)
    assert (p.kbeg, p.kend, p.tiles, p.splits, p.tiles_per_split, p.rows) == (0, 513, 17, 9, 2, 7)
    assert 8 * 4 * p.splits >= 2 * 132
    assert p.acc_shape == (8, 4, 9, 7, 128) and p.ml_shape == (8, 4, 9, 7, 2)


@pytest.mark.parametrize("B,T,off,num_sms", [
    (8, 1, 0, 132), (8, 40, 39, 132), (8, 528, 527, 132), (1, 528, 200, 132),
    (2, 70, 65, 132), (3, 1000, 999, 16), (16, 33, 32, 132),
])
def test_decode_plan_covers_every_key_once(B, T, off, num_sms):
    """Ragged T: the splits cover [kbeg, kend) exactly, none is empty, and
    the grid covers the card twice when there are tiles enough."""
    K = 4
    p = decode_plan(B, 1, T, 28, K, 64, q_offset=off, num_sms=num_sms)
    assert p.kend == min(T, off + 1) and p.tiles == math.ceil(p.kend / 32)
    spans = [(p.kbeg + i * 32 * p.tiles_per_split,
              min(p.kend, p.kbeg + (i + 1) * 32 * p.tiles_per_split)) for i in range(p.splits)]
    assert all(lo < hi for lo, hi in spans)
    assert spans[0][0] == p.kbeg and spans[-1][1] == p.kend
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert B * K * p.splits >= min(2 * num_sms, B * K * p.tiles)
    assert p.acc_shape == (B, K, p.splits, 7, 64) and p.ml_shape == (B, K, p.splits, 7, 2)


def test_decode_plan_without_keys():
    # a window that ends before the first cached key: one split, no tile
    p = decode_plan(2, 1, 4, 8, 2, 64, window=2, q_offset=10)
    assert (p.tiles, p.splits, p.tiles_per_split) == (0, 1, 0)


def test_decode_rows_cap():
    assert DECODE_MAX_ROWS == 64
    assert decode_plan(1, 8, 64, 64, 8, 64, q_offset=56).rows == DECODE_MAX_ROWS


def _flash_args(**kw):
    shape = dict(B=1, S=4, T=4, H=4, K=2, D=64, **kw)
    return (torch.zeros(shape["B"], shape["S"], shape["H"], shape["D"]),
            torch.zeros(shape["B"], shape["T"], shape["K"], shape["D"]),
            torch.zeros(shape["B"], shape["T"], shape["K"], shape["D"]))


@pytest.mark.parametrize("case", ["q off 16 bytes", "k off 16 bytes", "q_offset past 32 bits"])
def test_flash_sdpa_new_refusals(case):
    q, k, v = _flash_args()
    off = 0
    if case == "q off 16 bytes":
        q = torch.zeros(q.numel() + 1)[1:].view(q.shape)  # 4 bytes past an aligned start
    elif case == "k off 16 bytes":
        k = torch.zeros(k.numel() + 2)[2:].view(k.shape)
    else:
        off = 2**31 - 2
    with pytest.raises(ValueError):
        flash_sdpa(q, k, v, q_offset=off)


def _plan(B, S, T, H, K, D, splits, window=0, off=0):
    """A plan with exactly ``splits`` splits (the last ones may see no key)."""
    kend, kbeg = min(T, off + S), (max(0, off - window + 1) if window else 0)
    tiles = -(-max(kend - kbeg, 0) // 32)
    per = max(1, -(-tiles // splits))
    R = S * (H // K)
    return DecodePlan(kbeg, kend, tiles, splits, per, R, (B, K, splits, R, D), (B, K, splits, R, 2))


MERGE_CASES = [  # B, S, T, H, K, D, window, q_offset, splits
    (2, 1, 528, 28, 4, 128, 0, 512, 1),
    (2, 1, 528, 28, 4, 128, 0, 512, 8),
    (1, 1, 40, 14, 2, 64, 0, 33, 2),  # ragged T, 2 tiles
    (1, 1, 40, 14, 2, 64, 0, 33, 3),  # a third split with no key
    (2, 3, 100, 6, 2, 64, 0, 97, 4),  # S = G = 3
    (1, 2, 200, 8, 4, 128, 40, 150, 5),  # a window: early splits see no key
    (1, 1, 4, 2, 1, 64, 2, 10, 1),  # no key at all -> 0
    (1, 1, 100, 4, 4, 80, 0, 97, 3),  # zamba2-2.7b's head dim, MHA
]


@pytest.mark.parametrize("B,S,T,H,K,D,window,off,splits", MERGE_CASES)
def test_merge_partials_matches_plain_and_repro(B, S, T, H, K, D, window, off, splits):
    rng = np.random.default_rng(B * T + splits + window)
    q = rng.normal(0, 1, (B, S, H, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, T, K, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, T, K, D)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    plan = _plan(B, S, T, H, K, D, splits, window, off)
    acc, ml = decode_partials_ref(tq, tk, tv, plan, window=window, q_offset=off)
    assert acc.shape == plan.acc_shape and ml.shape == plan.ml_shape
    got = merge_partials_ref(acc, ml, S)
    want = flash_sdpa_ref(tq, tk, tv, window=window, q_offset=off)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=0)
    j_want = j_flash_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), tq=64, tk=64,
                          window=window, q_offset=off)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_want), atol=2e-6)


def test_merge_with_an_empty_split_gives_the_fully_masked_zero():
    rng = np.random.default_rng(3)
    q, k = torch.from_numpy(rng.normal(0, 1, (1, 1, 2, 64)).astype(np.float32)), torch.zeros(1, 4, 1, 64)
    plan = _plan(1, 1, 4, 2, 1, 64, 3, window=2, off=10)
    acc, ml = decode_partials_ref(q, k, k, plan, window=2, q_offset=10)
    assert torch.isneginf(ml[..., 0]).all() and (ml[..., 1] == 0).all()
    assert torch.equal(merge_partials_ref(acc, ml, 1), torch.zeros(1, 1, 2, 64))


def _bf16_p_flash(q, k, v, tile=128):
    """The tensor-core route's arithmetic: causal online softmax over 128-key
    tiles in float32 (log2 domain), P rounded to bf16 before P V, the
    denominator from the unrounded P, the output rounded to bf16 once."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qf = q.float().reshape(B, S, K, G, D)
    kf, vf = k.float(), v.float()
    scale = 1.4426950408889634 / math.sqrt(D)
    m = torch.full((B, K, G, S), float("-inf"))
    l = torch.zeros(B, K, G, S)
    acc = torch.zeros(B, K, G, S, D)
    pos = torch.arange(S)[:, None]
    for t0 in range(0, T, tile):
        x = torch.einsum("bskgd,btkd->bkgst", qf, kf[:, t0:t0 + tile]) * scale
        x = x.masked_fill(t0 + torch.arange(x.shape[-1])[None, :] > pos, float("-inf"))
        m_new = torch.maximum(m, x.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgst,btkd->bkgsd", p.bfloat16().float(),
                                                    vf[:, t0:t0 + tile])
        m = m_new
    out = acc / l[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D)


def test_bf16_p_rounding_stays_within_the_card_tolerance():
    """At reduced qwen2-7b widths (GQA 7:1, D = 128, S = 256): rounding P to
    bf16 moves each output by at most 2^-8 sum_j p_j |v_j| / l (bf16 keeps 8
    significant bits: a rounding moves p by at most 2^-8 p), which is at most
    2^-8 max |v|; with the output's own bf16 rounding on both sides that is
    the card tests' atol 2^-8 max |v|, rtol 2^-7."""
    rng = np.random.default_rng(7)
    B, S, H, K, D = 2, 256, 14, 2, 128
    q, k, v = (torch.from_numpy(rng.normal(0, s, shape).astype(np.float32)).bfloat16()
               for s, shape in ((1.0, (B, S, H, D)), (1.0, (B, S, K, D)), (2.0, (B, S, K, D))))
    emul = _bf16_p_flash(q, k, v)
    exact = flash_sdpa_ref(q.float(), k.float(), v.float())
    # the derivation, row by row: |emul - exact| <= 2^-8 sum_j p_j |v_j| / l
    qf = q.float().reshape(B, S, K, H // K, D)
    s = torch.einsum("bskgd,btkd->bkgst", qf, k.float()) / math.sqrt(D)
    s = s.masked_fill(torch.triu(torch.ones(S, S, dtype=torch.bool), 1), float("-inf"))
    p = torch.softmax(s, -1)
    weighted = torch.einsum("bkgst,btkd->bkgsd", p, v.float().abs())
    weighted = weighted.permute(0, 3, 1, 2, 4).reshape(B, S, H, D)
    assert ((emul - exact).abs() <= 2 ** -8 * weighted + 1e-6).all()
    assert float(weighted.max()) <= float(v.float().abs().max())
    got, want = emul.bfloat16().float(), flash_sdpa_ref(q, k, v).float()
    torch.testing.assert_close(got, want, atol=2 ** -8 * float(v.float().abs().max()), rtol=2 ** -7)
    # the rounding is real: the emulation is not the float32 result
    assert float((emul - exact).abs().max()) > 1e-4
