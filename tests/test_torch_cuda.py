"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``gpu``: on a host without CUDA every test here skips.  Run on the
card with ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py``
(this file imports neither ``jax`` nor ``repro``, so it runs where only the
port is installed)."""
import numpy as np
import pytest
import torch

from repro_torch.detection.batch import DetectionsBatch
from repro_torch.detection.nms import nms_batch
from repro_torch.kernels.estimator_mlp import estimator_mlp, estimator_mlp_ref
from repro_torch.kernels.estimator_mlp.ops import device_clusters, mlp_plan
from repro_torch.kernels.flash_sdpa import flash_sdpa, flash_sdpa_ref
from repro_torch.kernels.iou_matrix import (
    iou_matrix,
    iou_matrix_batch,
    iou_matrix_batch_ref,
    iou_matrix_ref,
)
from repro_torch.kernels.score_pipeline import score_pipeline, score_pipeline_ref
from repro_torch.kernels.wkv6 import wkv6, wkv6_ref

NUM_CLASSES, TOP_K = 8, 25
F = TOP_K * (7 + NUM_CLASSES) + 4 + NUM_CLASSES

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (Hopper, sm_90a)")
    return torch.device("cuda")


def boxes(rng, shape):
    b = rng.uniform(0, 50, shape + (2,))
    return np.concatenate([b, b + rng.uniform(1, 20, shape + (2,))], -1).astype(np.float32)


def mlp(rng, f, h, dev):
    return [torch.tensor(v, device=dev) for v in (
        rng.normal(0, 0.1, (f, h)).astype(np.float32), rng.normal(0, 0.1, h).astype(np.float32),
        rng.normal(0, 0.1, h).astype(np.float32), np.float32(0.05))]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,K,M", [(1, 1, 1), (512, 64, 8), (3, 70, 33)])
def test_iou_kernels(dev, dtype, tol, B, K, M):
    rng = np.random.default_rng(B + K + M)
    a = torch.tensor(boxes(rng, (B, K)), device=dev).to(dtype)
    g = torch.tensor(boxes(rng, (B, M)), device=dev).to(dtype)
    before = iou_matrix_batch.launches
    got = iou_matrix_batch(a, g)
    assert iou_matrix_batch.launches == before + 1 and got.dtype == dtype
    torch.testing.assert_close(got.float(), iou_matrix_batch_ref(a, g).float(), atol=tol, rtol=0)
    torch.testing.assert_close(iou_matrix(a[0], g[0]).float(),
                               iou_matrix_ref(a[0], g[0]).float(), atol=tol, rtol=0)


@pytest.mark.parametrize("B", [1, 64])
def test_nms_on_card_equals_cpu(dev, B):
    # a request's NMS (iou_matrix_batch) and a single frame's (iou_matrix)
    rng = np.random.default_rng(B)
    b = torch.tensor(boxes(rng, (B, 64)))
    s = torch.tensor((np.round(rng.uniform(0, 1, (B, 64)) * 8) / 8).astype(np.float32))
    c = torch.tensor(rng.integers(0, 3, (B, 64)).astype(np.int32))
    wrapper = iou_matrix if B == 1 else iou_matrix_batch
    before = wrapper.launches
    got = nms_batch(b.to(dev), s.to(dev), c.to(dev), 0.45, 0.25)
    assert wrapper.launches == before + 1
    want = nms_batch(b, s, c, 0.45, 0.25)
    assert torch.equal(got.cpu(), want) and want.any() and not want.all()


@pytest.mark.parametrize("B,f,h", [
    (1, F, 128), (37, F, 128), (4096, F, 128), (9, 33, 17), (5, 700, 300),
    # the LM head (one CTA a cluster, rows finished in registers); a tile
    # count that is no multiple of the grid; H odd with 4-rank slices (a tail
    # past the bulk copy); W1 too large to stay resident (a 2-stage ring of
    # slabs); more tiles than the card holds clusters (clusters walk tiles)
    (8, 12, 64), (513, F, 128), (37, 203, 65), (300, 4096, 1024), (20000, F, 128),
])
def test_estimator_mlp_kernel(dev, B, f, h):
    rng = np.random.default_rng(B)
    x = torch.tensor(rng.normal(0, 1, (B, f)).astype(np.float32), device=dev)
    w = mlp(rng, f, h, dev)
    before = estimator_mlp.launches
    torch.testing.assert_close(estimator_mlp(x, *w), estimator_mlp_ref(x, *w), atol=1e-5, rtol=0)
    assert estimator_mlp.launches == before + 1
    assert estimator_mlp(x[:0], *w).shape == (0,)


def test_estimator_mlp_plan_corners_on_card(dev):
    """The plans the tests above launch cover every corner of mlp_plan, on
    the cluster capacity the device reports."""
    held = dict(device_clusters(dev))
    assert set(held) == {1, 2, 4, 8} and all(n >= 1 for n in held.values())
    assert held[8] * 8 <= torch.cuda.get_device_properties(dev).multi_processor_count
    plans = [mlp_plan(B, f, h, clusters=device_clusters(dev))
             for B, f, h in [(8, 12, 64), (1, F, 128), (4096, F, 128), (37, 203, 65), (300, 4096, 1024),
                             (20000, F, 128)]]
    assert [p.cs for p in plans] == [1, 4, 2, 4, 8, 2]
    lo, hi = plans[3].bounds[-2:]
    assert ((hi - lo) * 65 * 4) % 16 != 0  # a tail past the last bulk copy
    assert plans[4].stages == 2  # a ring of slabs
    assert plans[5].tiles > plans[5].grid // plans[5].cs  # clusters walk several tiles


def test_misaligned_w1_raises(dev):
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(0, 1, (4, F)).astype(np.float32), device=dev)
    w1, b1, w2, b2 = mlp(rng, F, 128, dev)
    shifted = torch.empty(F * 128 + 1, device=dev)[1:].view(F, 128)
    shifted.copy_(w1)
    with pytest.raises(ValueError, match="16-byte aligned"):
        estimator_mlp(x, shifted, b1, w2, b2)


def test_head_reads_weights_written_just_before(dev):
    """Both kernels are programmatic dependent launches: weights that the
    kernel just before writes (here a PyTorch op, with no sync between) are
    what they read, in a chain of head launches too."""
    rng = np.random.default_rng(3)
    src = mlp(rng, F, 128, dev)
    w = [torch.empty_like(t) for t in src]
    batch = DetectionsBatch(
        boxes=torch.tensor(boxes(rng, (64, 64)), device=dev),
        scores=torch.tensor(rng.uniform(0, 1, (64, 64)).astype(np.float32), device=dev),
        classes=torch.tensor(rng.integers(0, NUM_CLASSES, (64, 64)).astype(np.int32), device=dev),
        mask=torch.tensor(rng.uniform(0, 1, (64, 64)) < 0.7, device=dev),
    )
    ones, zeros = torch.ones(F, device=dev), torch.zeros(F, device=dev)
    x = torch.tensor(rng.normal(0, 1, (64, F)).astype(np.float32), device=dev)
    got = []
    for scale in (0.5, -1.0, 2.0, 0.25):
        for t, s in zip(w, src):
            torch.mul(s, scale, out=t)
        got.append(estimator_mlp(x, *w))
        params = dict(w1=w[0], b1=w[1], w2=w[2], b2=w[3], mu=zeros, sigma=ones)
        got.append(score_pipeline(batch, params, num_classes=NUM_CLASSES, top_k=TOP_K,
                                  image_size=64.0))
    torch.cuda.synchronize(dev)
    for i, scale in enumerate((0.5, -1.0, 2.0, 0.25)):
        ws = [s * scale for s in src]
        torch.testing.assert_close(got[2 * i], estimator_mlp_ref(x, *ws), atol=1e-5, rtol=0)
        want = score_pipeline_ref(batch.boxes, batch.scores, batch.classes, batch.mask, *ws,
                                  zeros, ones, 64.0, NUM_CLASSES, TOP_K)
        torch.testing.assert_close(got[2 * i + 1], want, atol=2e-6, rtol=0)


@pytest.mark.parametrize("B,K,ties,empty", [
    (64, 64, 4, 0.2), (512, 24, None, 0.1), (8, 8, 2, 1.0), (3, 70, 3, 0.0),
    # a single frame (4-rank cluster), one all masked, K < top_k at B 1; a
    # tile count that is no multiple of the grid with clusters walking tiles
    (1, 64, None, 0.0), (1, 64, 4, 1.0), (1, 12, 3, 0.0), (4096, 16, 3, 0.1), (37, 64, 4, 0.3),
])
def test_score_pipeline_kernel(dev, B, K, ties, empty):
    """Tied scores check the in-kernel stable rank against the plain
    version's stable argsort; K < top_k and all-masked rows too."""
    rng = np.random.default_rng(B * K)
    scores = rng.uniform(0, 1, (B, K))
    if ties:
        scores = np.round(scores * ties) / ties
    counts = rng.integers(1, K + 1, B)
    counts[: int(empty * B)] = 0
    mask = np.arange(K)[None] < counts[:, None]
    batch = DetectionsBatch(
        boxes=torch.tensor(boxes(rng, (B, K)), device=dev),
        scores=torch.tensor(scores.astype(np.float32), device=dev),
        classes=torch.tensor(np.where(mask, rng.integers(0, NUM_CLASSES, (B, K)), -1), device=dev),
        mask=torch.tensor(mask, device=dev),
    )
    w1, b1, w2, b2 = mlp(rng, F, 128, dev)
    mu = torch.tensor(rng.normal(0, 0.1, F).astype(np.float32), device=dev)
    sigma = torch.tensor(rng.uniform(0.5, 2, F).astype(np.float32), device=dev)
    params = dict(w1=w1, b1=b1, w2=w2, b2=b2, mu=mu, sigma=sigma)
    before = score_pipeline.launches
    got = score_pipeline(batch, params, num_classes=NUM_CLASSES, top_k=TOP_K, image_size=64.0)
    assert score_pipeline.launches == before + 1
    want = score_pipeline_ref(batch.boxes, batch.scores, batch.classes, batch.mask,
                              *params.values(), 64.0, NUM_CLASSES, TOP_K)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=0)
    shifted = torch.empty(F * 128 + 1, device=dev)[1:].view(F, 128)
    shifted.copy_(w1)
    with pytest.raises(ValueError, match="16-byte aligned"):
        score_pipeline(batch, {**params, "w1": shifted}, num_classes=NUM_CLASSES, top_k=TOP_K)


def _bf16_tol(v, route):
    """A bf16 route's tolerance against the float32 plain version.  The
    simt and decode routes compute in float32 and round the output once:
    one bf16 rounding apart.  The tensor-core route also rounds P to bf16
    before P V, which moves a row by at most 2^-8 sum_j p_j |v_j| / l <=
    2^-8 max |v| (tests/test_torch_flash_routes.py checks the bound on the
    CPU)."""
    if route == "wgmma":
        return dict(atol=2 ** -8 * float(v.float().abs().max()), rtol=2 ** -7)
    return dict(atol=1e-6, rtol=2 ** -7)


def _flash_inputs(rng, B, S, T, H, K, D, dev, dtype=torch.float32):
    return (torch.tensor(rng.normal(0, 1, shape).astype(np.float32), device=dev).to(dtype)
            for shape in ((B, S, H, D), (B, T, K, D), (B, T, K, D)))


def _route_launches(route, call):
    """Runs ``call`` and asserts it launched exactly the kernels of ``route``."""
    before = dict(flash_sdpa.launches_by_route)
    got = call()
    want = {"decode": ("decode", "decode_combine")}.get(route, (route,))
    after = flash_sdpa.launches_by_route
    assert {r: after[r] - before[r] for r in after} == {r: int(r in want) for r in after}
    return got


@pytest.mark.parametrize("B,S,T,H,K,D,window,off", [
    (1, 128, 128, 2, 1, 32, 0, 0),
    (2, 256, 256, 4, 2, 64, 0, 0),
    (1, 100, 300, 4, 4, 32, 0, 200),
    (2, 256, 256, 4, 2, 64, 64, 0),
    (1, 64, 512, 8, 2, 128, 128, 448),
    (2, 1, 40, 28, 4, 128, 0, 33),  # a decode step: one query at pos 33
    (1, 3, 4, 2, 1, 32, 2, 10),  # every row fully masked -> 0
])
def test_flash_sdpa_kernel(dev, B, S, T, H, K, D, window, off):
    from repro_torch.kernels.flash_sdpa.ops import flash_route

    rng = np.random.default_rng(S * T + D)
    q, k, v = _flash_inputs(rng, B, S, T, H, K, D, dev)
    before = flash_sdpa.launches
    got = _route_launches("simt", lambda: flash_sdpa(q, k, v, window=window, q_offset=off))
    assert flash_sdpa.launches == before + 1
    torch.testing.assert_close(got, flash_sdpa_ref(q, k, v, window=window, q_offset=off),
                               atol=2e-6, rtol=0)
    # bf16 in and out: the route of its shape (wgmma, decode or simt)
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    route = flash_route(qb.dtype, S, D, H // K)
    got = _route_launches(route, lambda: flash_sdpa(qb, kb, vb, window=window, q_offset=off))
    torch.testing.assert_close(got.float(),
                               flash_sdpa_ref(qb, kb, vb, window=window, q_offset=off).float(),
                               **_bf16_tol(vb, route))


@pytest.mark.parametrize("B,S,T,H,K,D,window,off,causal", [
    (8, 512, 512, 28, 4, 128, 0, 0, True),  # qwen2-7b prefill
    (2, 200, 200, 8, 2, 64, 0, 0, True),  # S not a multiple of 128
    (1, 130, 300, 4, 1, 128, 0, 170, True),  # offset queries, ragged T
    (2, 256, 256, 4, 2, 64, 64, 0, True),  # sliding window
    (1, 77, 333, 6, 3, 128, 100, 256, True),  # window + offset, ragged
    (2, 100, 150, 4, 4, 64, 0, 0, False),  # no causal mask
    (1, 9, 20, 4, 2, 128, 3, 30, True),  # rows that see no key -> 0
])
def test_flash_sdpa_wgmma_route(dev, B, S, T, H, K, D, window, off, causal):
    rng = np.random.default_rng(B * S + T + D)
    q, k, v = _flash_inputs(rng, B, S, T, H, K, D, dev, torch.bfloat16)
    got = _route_launches("wgmma", lambda: flash_sdpa(q, k, v, causal=causal, window=window,
                                                      q_offset=off))
    want = flash_sdpa_ref(q, k, v, causal=causal, window=window, q_offset=off)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **_bf16_tol(v, "wgmma"))


@pytest.mark.parametrize("G", [1, 2, 7])
@pytest.mark.parametrize("T", [1, 40, 528])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_sdpa_decode_route(dev, G, T, D):
    """One query a head at the cache's last filled slot (T = 528: qwen2-7b's
    decode step at position 512 of a 528-slot cache), through the split-K
    route; the slots past the position hold garbage the mask must hide."""
    B, K = 8, 4
    off = min(T - 1, 512)
    rng = np.random.default_rng(G * T + D)
    q, k, v = _flash_inputs(rng, B, 1, T, G * K, K, D, dev, torch.bfloat16)
    k[:, off + 1:] = float("nan")
    v[:, off + 1:] = float("nan")
    got = _route_launches("decode", lambda: flash_sdpa(q, k, v, q_offset=off))
    want = flash_sdpa_ref(q, k[:, :off + 1], v[:, :off + 1], q_offset=off)
    torch.testing.assert_close(got.float(), want.float(), **_bf16_tol(v, "decode"))
    # two queries a head (S <= G) and a window: rows with fewer keys
    if G >= 2 and T > 1:
        q2 = q.repeat(1, 2, 1, 1)[:, :2].contiguous()
        got = _route_launches("decode", lambda: flash_sdpa(q2, k, v, window=9, q_offset=off - 1))
        want = flash_sdpa_ref(q2, k[:, :off + 1], v[:, :off + 1], window=9, q_offset=off - 1)
        torch.testing.assert_close(got.float(), want.float(), **_bf16_tol(v, "decode"))


@pytest.mark.parametrize("B,T,H,K,V", [(1, 8, 1, 8, 8), (2, 64, 3, 16, 16), (2, 33, 2, 64, 64),
                                        (3, 1, 4, 32, 32), (2, 70, 2, 64, 64), (8, 512, 32, 64, 64),
                                        (2, 45, 3, 64, 33), (1, 17, 2, 32, 128)])
@pytest.mark.parametrize("xdt,wdt", [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                                     (torch.bfloat16, torch.bfloat16)])
def test_wkv6_kernel(dev, B, T, H, K, V, xdt, wdt):
    rng = np.random.default_rng(B * T + K)

    def arr(shape, lo=None, hi=None, scale=1.0):
        a = rng.uniform(lo, hi, shape) if lo is not None else rng.normal(0, scale, shape)
        return torch.tensor(a.astype(np.float32), device=dev)

    r, k, v = arr((B, T, H, K)).to(xdt), arr((B, T, H, K)).to(xdt), arr((B, T, H, V)).to(xdt)
    w, u, s0 = arr((B, T, H, K), 0.5, 0.99).to(wdt), arr((H, K), scale=0.2), arr((B, H, K, V), scale=0.1)
    before, shape = wkv6.launches, "prefill" if T > 1 else "decode"
    by_shape = wkv6.launches_by_shape[shape]
    out, sT = wkv6(r, k, v, w, u, s0)
    assert wkv6.launches == before + 1 and wkv6.launches_by_shape[shape] == by_shape + 1
    assert out.dtype == sT.dtype == torch.float32
    want_out, want_s = wkv6_ref(r, k, v, w, u, s0)
    # the same float32 inputs on both sides: only the summation order differs.
    # At rwkv6-1.6b's prefill shape the state sums ~100 decayed terms over 512
    # steps and each output is a 64-long dot product of them, so the rounding
    # scales with the largest output: there 1e-5 of max |out| (and of max
    # |state|), as chip_smoke.py holds that shape
    big = (B, T, H, K, V) == (8, 512, 32, 64, 64)
    tol_out = 1e-5 * float(want_out.abs().max()) if big else 1e-5
    tol_s = 1e-5 * float(want_s.abs().max()) if big else 1e-5
    torch.testing.assert_close(out, want_out, atol=tol_out, rtol=0 if big else 1e-5)
    torch.testing.assert_close(sT, want_s, atol=tol_s, rtol=0 if big else 1e-5)


@pytest.mark.parametrize("arch", ["qwen2_7b", "rwkv6_1b6"])
def test_lm_decode_matches_forward_on_card(dev, arch):
    """A reduced float32 model on the card: kernels against the plain
    versions, and decode at position S against the forward on S + 1 tokens
    (the contract of tests/test_archs_smoke.py)."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = lm.reduced(get_config(arch))
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    toks = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)), device=dev)
    logits, _ = lm.forward(params, cfg, {"tokens": toks})
    plain, _ = lm.forward(params, cfg, {"tokens": toks}, plain=True)
    torch.testing.assert_close(logits, plain, atol=1e-5, rtol=0)
    last, cache = lm.prefill(params, cfg, {"tokens": toks}, capacity=20)
    nxt = last.argmax(-1)
    dl, _ = lm.decode_step(params, cfg, cache, nxt, 16)
    full, _ = lm.forward(params, cfg, {"tokens": torch.cat([toks, nxt[:, None]], 1)})
    torch.testing.assert_close(dl, full[:, -1], atol=5e-4, rtol=0)
