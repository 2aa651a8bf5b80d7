"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``gpu``: on a host without CUDA every test here skips.  Run on the
card with ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py``
(this file imports neither ``jax`` nor ``repro``, so it runs where only the
port is installed)."""
import json

import numpy as np
import pytest
import torch

from repro_torch.detection.batch import DetectionsBatch, GroundTruthBatch, match_batch
from repro_torch.detection.nms import nms_batch
from repro_torch.kernels.estimator_mlp import estimator_mlp, estimator_mlp_ref
from repro_torch.kernels.estimator_mlp.ops import device_clusters, mlp_plan
from repro_torch.kernels.flash_sdpa import flash_sdpa, flash_sdpa_ref
from repro_torch.kernels.iou_matrix import (
    greedy_match,
    greedy_match_ref,
    iou_matrix,
    iou_matrix_batch,
    iou_matrix_batch_ref,
    iou_matrix_ref,
    nms_keep,
    nms_keep_ref,
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


def _route_counts():
    return {w.__name__: dict(w.launches_by_route) for w in (iou_matrix, iou_matrix_batch)}


def _one_launch(B, route, before):
    """Exactly one launch, of ``route``, counted in iou_matrix at B = 1 and
    in iou_matrix_batch past it."""
    after = _route_counts()
    want = {w: dict.fromkeys(c, 0) for w, c in before.items()}
    want["iou_matrix" if B == 1 else "iou_matrix_batch"][route] = 1
    assert {w: {r: after[w][r] - n for r, n in c.items()} for w, c in before.items()} == want


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,K,M", [(1, 1, 1), (512, 64, 8), (3, 70, 33), (64, 64, 64), (2, 5, 8193 - 1)])
def test_iou_kernels(dev, dtype, tol, B, K, M):
    """The matrix route: 16-byte stores where M % 4 == 0, a scalar tail
    otherwise; one launch, counted by B."""
    rng = np.random.default_rng(B + K + M)
    a = torch.tensor(boxes(rng, (B, K)), device=dev).to(dtype)
    g = torch.tensor(boxes(rng, (B, M)), device=dev).to(dtype)
    before = _route_counts()
    got = iou_matrix_batch(a, g)
    _one_launch(B, "matrix", before)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), iou_matrix_batch_ref(a, g).float(), atol=tol, rtol=0)
    before = _route_counts()
    got = iou_matrix(a[0], g[0])
    _one_launch(1, "matrix", before)
    torch.testing.assert_close(got.float(), iou_matrix_ref(a[0], g[0]).float(), atol=tol, rtol=0)


@pytest.mark.parametrize("B", [1, 64])
def test_nms_on_card_equals_cpu(dev, B):
    # a request's NMS and a single frame's: one launch of the nms route each
    rng = np.random.default_rng(B)
    b = torch.tensor(boxes(rng, (B, 64)))
    s = torch.tensor((np.round(rng.uniform(0, 1, (B, 64)) * 8) / 8).astype(np.float32))
    c = torch.tensor(rng.integers(0, 3, (B, 64)).astype(np.int32))
    before = _route_counts()
    got = nms_batch(b.to(dev), s.to(dev), c.to(dev), 0.45, 0.25)
    _one_launch(B, "nms", before)
    want = nms_batch(b, s, c, 0.45, 0.25)
    assert torch.equal(got.cpu(), want) and want.any() and not want.all()


def _nms_case(rng, B, N, dev, pad=0, ties=8):
    b = boxes(rng, (B, N))
    s = rng.uniform(0, 1, (B, N))
    if ties:
        s = np.round(s * ties) / ties
    c = rng.integers(0, 3, (B, N))
    if pad:
        b[:, N - pad:], s[:, N - pad:], c[:, N - pad:] = 0.0, 0.0, -1
    return (torch.tensor(b, device=dev), torch.tensor(s.astype(np.float32), device=dev),
            torch.tensor(c.astype(np.int32), device=dev))


@pytest.mark.parametrize("B,N", [(1, 1), (3, 63), (64, 64), (2, 65), (5, 130), (256, 64),
                                 (512, 64), (2, 1024)])
@pytest.mark.parametrize("iou_thr,score_thr", [(0.45, 0.25), (0.5, 0.0)])
def test_nms_route_equals_plain(dev, B, N, iou_thr, score_thr):
    """Exactly equal keep masks: tied scores (the stable rank), 64-bit word
    edges, class -1 padding, N up to the route's limit."""
    rng = np.random.default_rng(B * N)
    args = _nms_case(rng, B, N, dev, pad=N // 5) + (iou_thr, score_thr)
    before = _route_counts()
    got = nms_keep(*args)
    _one_launch(B, "nms", before)
    assert got.dtype == torch.bool and torch.equal(got, nms_keep_ref(*args))


def test_nms_route_iou_at_threshold(dev):
    b = torch.tensor([[[0, 0, 2, 1], [0, 0, 1, 1]]], dtype=torch.float32, device=dev)
    s = torch.tensor([[0.9, 0.8]], device=dev)
    c = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    assert nms_keep(b, s, c, 0.5, 0.0).tolist() == [[True, True]]
    assert nms_keep(b, s, c, 0.49, 0.0).tolist() == [[True, False]]


def _match_case(rng, B, K, M, dev, empty=1):
    """Detections near the ground truth, tied scores, prefix masks, class -1
    padding, the first ``empty`` images without a detection."""
    gt = boxes(rng, (B, M))
    g_cls = rng.integers(0, 2, (B, M))
    src = rng.integers(0, M, (B, K))
    det = np.take_along_axis(gt, src[..., None], 1) + rng.normal(0, 2.0, (B, K, 4))
    det[..., 2:] = np.maximum(det[..., 2:], det[..., :2] + 0.5)
    near = np.take_along_axis(g_cls, src, 1)
    d_cls = np.where(rng.uniform(0, 1, (B, K)) < 0.8, near, 1 - near)
    d_mask = np.arange(K)[None] < rng.integers(1, K + 1, B)[:, None]
    d_mask[:empty] = False
    g_mask = np.arange(M)[None] < rng.integers(1, M + 1, B)[:, None]
    arrays = (np.where(d_mask[..., None], det, 0).astype(np.float32),
              (np.round(rng.uniform(0, 1, (B, K)) * 8) / 8).astype(np.float32),
              np.where(d_mask, d_cls, -1).astype(np.int32), d_mask,
              np.where(g_mask[..., None], gt, 0).astype(np.float32),
              np.where(g_mask, g_cls, -1).astype(np.int32), g_mask)
    return [torch.tensor(a, device=dev) for a in arrays]


COCO = np.round(np.linspace(0.5, 0.95, 10), 2).astype(np.float32)


@pytest.mark.parametrize("B,K,M", [(1, 5, 1), (4, 64, 8), (3, 64, 32), (3, 64, 33), (512, 64, 8),
                                   (2, 300, 1024), (2, 1024, 40)])
@pytest.mark.parametrize("T", [1, 2, 10])
def test_match_route_equals_plain(dev, B, K, M, T):
    """Exactly equal tp and match_gt: warp edges of M, COCO's 10 thresholds
    (warps loop over T), IoU tiles in several chunks (M 1024), K up to 1024,
    an all-masked image (B > 1), class -1 padding."""
    rng = np.random.default_rng(B * K + M + T)
    args = _match_case(rng, B, K, M, dev, empty=int(B > 1)) + [torch.tensor(COCO[:T] if T > 2 else [0.5, 0.75][:T],
                                                          device=dev)]
    before = _route_counts()
    tp, mj = greedy_match(*args)
    _one_launch(B, "match", before)
    want_tp, want_mj = greedy_match_ref(*args)
    assert tp.dtype == torch.bool and mj.dtype == torch.int32
    assert torch.equal(tp, want_tp) and torch.equal(mj, want_mj)
    assert want_tp.any() or B == 1  # the seeded 5 x 1 image may hold no hit


def test_match_route_iou_at_threshold_and_empty_axes(dev):
    f = dict(device=dev)
    one = dict(dtype=torch.int32, **f)
    args = [torch.tensor([[[0, 0, 1, 1]]], dtype=torch.float32, **f), torch.tensor([[0.9]], **f),
            torch.zeros((1, 1), **one), torch.ones((1, 1), dtype=torch.bool, **f),
            torch.tensor([[[0, 0, 2, 1]]], dtype=torch.float32, **f), torch.zeros((1, 1), **one),
            torch.ones((1, 1), dtype=torch.bool, **f), torch.tensor([0.5, 0.55], **f)]
    tp, mj = greedy_match(*args)
    assert tp.tolist() == [[[True], [False]]] and mj.tolist() == [[[0], [-1]]]
    # K = 0 or M = 0: all misses, no launch
    rng = np.random.default_rng(0)
    before = _route_counts()
    for K, M in ((0, 8), (8, 0)):
        d = _match_case(rng, 3, max(K, 1), max(M, 1), dev)
        d = [t[:, :K] for t in d[:4]] + [t[:, :M] for t in d[4:]]
        tp, mj = greedy_match(*[t.contiguous() for t in d], torch.tensor(COCO, device=dev))
        assert tp.shape == (3, 10, K) and not tp.any() and (mj == -1).all()
    assert _route_counts() == before


def test_routes_refuse_past_limits(dev):
    """Past a route's limit a CUDA tensor raises; nothing takes the plain
    version."""
    rng = np.random.default_rng(1)
    before = _route_counts()
    with pytest.raises(ValueError, match="N <= 1024"):
        nms_keep(*_nms_case(rng, 1, 1025, dev))
    m = _match_case(rng, 1, 8, 1025, dev)
    with pytest.raises(ValueError, match="M <= 1024"):
        greedy_match(*m, torch.tensor([0.5], device=dev))
    a = torch.tensor(boxes(rng, (1, 4)), device=dev)
    with pytest.raises(ValueError, match="M <= 8192"):
        iou_matrix_batch(a, torch.tensor(boxes(rng, (1, 8193)), device=dev))
    shifted = torch.empty(4 * 64 + 1, device=dev)[1:].view(1, 64, 4)
    with pytest.raises(ValueError, match="aligned"):
        iou_matrix_batch(shifted, shifted)
    assert _route_counts() == before


def _with_nan(a, at):
    """A copy of boxes ``a`` (B, N, 4) with NaN at each (image, slot,
    coordinate) of ``at``."""
    a = a.copy()
    for b, i, j in at:
        a[b, i, j] = np.nan
    return a


# one NaN coordinate in a box, each of x1, y1, x2, y2 once
NAN_AT = ((0, 1, 0), (1, 2, 1), (1, 5, 2), (2, 0, 3))


@pytest.mark.parametrize("side", ["first", "second", "both"])
def test_iou_routes_nan_boxes_equal_plain(dev, side):
    """A NaN coordinate in either box gives box_iou's 0 on every route (C's
    fmaxf / fminf drop the NaN: [NaN, 0, 5, 10] against [0, 0, 10, 10] gave
    1), so the matrix, the NMS keeps and the matches equal the plain
    versions exactly."""
    rng = np.random.default_rng(11)
    first, second = side in ("first", "both"), side in ("second", "both")
    p = torch.tensor([[float("nan"), 0, 5, 10]], device=dev)
    q = torch.tensor([[0.0, 0, 10, 10]], device=dev)
    p, q = (p, p) if first and second else (p, q) if first else (q, p)
    assert iou_matrix(p, q).tolist() == [[0.0]] == iou_matrix_ref(p, q).tolist()

    a, g = boxes(rng, (3, 8)), boxes(rng, (3, 6))
    a, g = (_with_nan(a, NAN_AT) if first else a), (_with_nan(g, NAN_AT) if second else g)
    a, g = torch.tensor(a, device=dev), torch.tensor(g, device=dev)
    assert torch.equal(iou_matrix_batch(a, g), iou_matrix_batch_ref(a, g))
    assert torch.equal(iou_matrix(a[0], g[0]), iou_matrix_ref(a[0], g[0]))

    if side != "second":  # NMS has one box set: NaN in a top-scored box and in others
        b, s, c = (t.cpu().numpy() for t in _nms_case(rng, 4, 64, dev, pad=8))
        at = [(i, int(np.argmax(s[i])), j) for i, _, j in NAN_AT] + list(NAN_AT)
        args = (torch.tensor(_with_nan(b, at), device=dev), torch.tensor(s, device=dev),
                torch.tensor(c, device=dev), 0.45, 0.25)
        for B in (1, 4):
            got = nms_keep(*(t[:B] for t in args[:3]), *args[3:])
            assert torch.equal(got, nms_keep_ref(*(t[:B] for t in args[:3]), *args[3:]))

    m = [t.cpu().numpy() for t in _match_case(rng, 3, 64, 8, dev, empty=0)]
    at = [(i, 0, j) for i, _, j in NAN_AT]
    if first:
        m[0] = _with_nan(m[0], at)
    if second:
        m[4] = _with_nan(m[4], at)
    args = [torch.tensor(x, device=dev) for x in m] + [torch.tensor(COCO, device=dev)]
    for B in (1, 3):
        tp, mj = greedy_match(*(t[:B] for t in args[:7]), args[7])
        want_tp, want_mj = greedy_match_ref(*(t[:B] for t in args[:7]), args[7])
        assert torch.equal(tp, want_tp) and torch.equal(mj, want_mj)


def test_score_pipeline_nan_boxes(dev):
    """A NaN coordinate stays NaN in its box features (box_feature_stack's
    w, h and aspect), so the image's estimate is NaN as in the plain version;
    the NaN pattern is held exactly, the other estimates at 2e-6."""
    rng = np.random.default_rng(12)
    B, K = 64, 64
    at = [(i, i % 3, i % 4) for i in range(0, B, 5)]
    scores, mask = rng.uniform(0, 1, (B, K)).astype(np.float32), rng.uniform(0, 1, (B, K)) < 0.7
    for i, k, _ in at:  # a valid box of the top k
        scores[i, k], mask[i, k] = 1.0, True
    batch = DetectionsBatch(
        boxes=torch.tensor(_with_nan(boxes(rng, (B, K)), at), device=dev),
        scores=torch.tensor(scores, device=dev),
        classes=torch.tensor(rng.integers(0, NUM_CLASSES, (B, K)).astype(np.int32), device=dev),
        mask=torch.tensor(mask, device=dev),
    )
    w1, b1, w2, b2 = mlp(rng, F, 128, dev)
    params = dict(w1=w1, b1=b1, w2=w2, b2=b2, mu=torch.zeros(F, device=dev),
                  sigma=torch.ones(F, device=dev))
    for rows in (slice(0, 1), slice(0, B)):
        sub = DetectionsBatch(boxes=batch.boxes[rows], scores=batch.scores[rows],
                              classes=batch.classes[rows], mask=batch.mask[rows])
        got = score_pipeline(sub, params, num_classes=NUM_CLASSES, top_k=TOP_K, image_size=64.0)
        want = score_pipeline_ref(sub.boxes, sub.scores, sub.classes, sub.mask, *params.values(),
                                  64.0, NUM_CLASSES, TOP_K)
        assert torch.equal(got.isnan(), want.isnan()) and want.isnan().any()
        torch.testing.assert_close(got, want, atol=2e-6, rtol=0, equal_nan=True)


def _aten_ops(fn):
    """The aten ops ``fn`` dispatches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(str(func.overloadpacket.__name__))
            return func(*args, **(kwargs or {}))

    with Record():
        fn()
    return seen


def test_nms_and_match_run_no_torch_sort(dev):
    """On the card nms_batch and match_batch are one launch each, with no
    sort, gather or scatter of PyTorch's around them."""
    rng = np.random.default_rng(2)
    b, s, c = _nms_case(rng, 64, 64, dev)
    d = _match_case(rng, 64, 64, 8, dev)
    det = DetectionsBatch(boxes=d[0], scores=d[1], classes=d[2], mask=d[3])
    gt = GroundTruthBatch(boxes=d[4], classes=d[5], mask=d[6])
    ops = _aten_ops(lambda: nms_batch(b, s, c, 0.45, 0.25)) + _aten_ops(
        lambda: match_batch(det, gt, (0.5, 0.75)))
    banned = [op for op in ops if any(w in op for w in ("sort", "gather", "scatter", "take_along",
                                                        "index", "argmax", "where"))]
    assert not banned, ops


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
    (2, 100, 300, 4, 2, 80, 0, 200),  # D = 80 (zamba2-2.7b): 3 columns a lane, guarded
    (2, 1, 528, 32, 32, 80, 0, 512),  # zamba2-2.7b's decode step in float32
    (1, 77, 200, 4, 4, 80, 50, 100),  # D = 80 under a window
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
    (8, 512, 512, 12, 2, 128, 0, 0, True),  # qwen2-vl-2b prefill (GQA 6)
    (8, 512, 512, 32, 32, 80, 0, 0, True),  # zamba2-2.7b prefill: D = 80, MHA
    (2, 200, 300, 4, 2, 80, 64, 100, True),  # D = 80: window + offset, ragged
    (2, 100, 150, 4, 4, 80, 0, 0, False),  # D = 80, no causal mask
    (8, 1500, 1500, 8, 8, 64, 0, 0, False),  # whisper-base encoder: bidirectional, ragged T
    (8, 512, 1500, 8, 8, 64, 0, 0, False),  # whisper-base cross-attention prefill
])
def test_flash_sdpa_wgmma_route(dev, B, S, T, H, K, D, window, off, causal):
    rng = np.random.default_rng(B * S + T + D)
    q, k, v = _flash_inputs(rng, B, S, T, H, K, D, dev, torch.bfloat16)
    got = _route_launches("wgmma", lambda: flash_sdpa(q, k, v, causal=causal, window=window,
                                                      q_offset=off))
    want = flash_sdpa_ref(q, k, v, causal=causal, window=window, q_offset=off)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **_bf16_tol(v, "wgmma"))


@pytest.mark.parametrize("G", [1, 2, 6, 7])
@pytest.mark.parametrize("T", [1, 40, 528])
@pytest.mark.parametrize("D", [64, 80, 128])
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


@pytest.mark.parametrize("G,T,D", [(1, 1500, 64), (1, 33, 64), (7, 1500, 128)])
def test_flash_sdpa_decode_route_non_causal(dev, G, T, D):
    """A decode step's cross-attention (whisper-base: G 1, D 64, the 1500
    encoder frames): every key visible whatever q_offset says, through the
    split-K route."""
    B, K = 8, 8 if G == 1 else 4
    rng = np.random.default_rng(G * T + D + 1)
    q, k, v = _flash_inputs(rng, B, 1, T, G * K, K, D, dev, torch.bfloat16)
    want = flash_sdpa_ref(q, k, v, causal=False)
    for off in (0, 17):
        got = _route_launches("decode", lambda: flash_sdpa(q, k, v, causal=False, q_offset=off))
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


def _modality_fields(cfg, B, S, dev, seed=0):
    """A VLM batch's vision prefix (``vision_patch_embeddings``) and M-RoPE
    ids (a grid of rows of 4 on the prefix, text after it); an
    encoder-decoder batch's ``audio_frame_embeddings``; {} otherwise."""
    from repro_torch.data.modality_stubs import audio_frame_embeddings, vision_patch_embeddings

    if cfg.arch_type == "encdec":
        af = audio_frame_embeddings(np.random.default_rng(seed), B, cfg.encoder_frames, cfg.d_model)
        return {"audio_frames": torch.from_numpy(af).to(dev)}
    if cfg.arch_type != "vlm":
        return {}

    V = cfg.vision_tokens
    p = np.zeros((3, B, S), np.int64)
    p[1, :, :V], p[2, :, :V] = np.arange(V) // 4, np.arange(V) % 4
    p[:, :, V:] = max(V // 4, 4) + np.arange(S - V)
    ve = vision_patch_embeddings(np.random.default_rng(seed), B, V, cfg.d_model)
    return {"vision_embeds": torch.from_numpy(ve).to(dev), "positions_3d": torch.from_numpy(p).to(dev)}


@pytest.mark.parametrize("arch", ["qwen2_7b", "rwkv6_1b6", "deepseek_moe_16b", "deepseek_v2_lite_16b",
                                  "qwen2_vl_2b", "zamba2_2b7", "whisper_base"])
def test_lm_decode_matches_forward_on_card(dev, arch):
    """A reduced float32 model on the card: kernels against the plain
    versions, and decode at position S against the forward on S + 1 tokens
    (the contract of tests/test_archs_smoke.py; a VLM's decode step takes
    1-D RoPE at S, so the forward's ids for that token are S)."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = lm.reduced(get_config(arch))
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    toks = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)), device=dev)
    batch = {"tokens": toks, **_modality_fields(cfg, 2, 16, dev)}
    logits, _ = lm.forward(params, cfg, batch)
    plain, _ = lm.forward(params, cfg, batch, plain=True)
    torch.testing.assert_close(logits, plain, atol=1e-5, rtol=0)
    last, cache = lm.prefill(params, cfg, batch, capacity=20)
    nxt = last.argmax(-1)
    dl, _ = lm.decode_step(params, cfg, cache, nxt, 16)
    ext = dict(batch, tokens=torch.cat([toks, nxt[:, None]], 1))
    if "positions_3d" in batch:
        ext["positions_3d"] = torch.cat([batch["positions_3d"],
                                         torch.full((3, 2, 1), 16, device=dev)], 2)
    full, _ = lm.forward(params, cfg, ext)
    torch.testing.assert_close(dl, full[:, -1], atol=5e-4, rtol=0)


@pytest.mark.parametrize("S", [1, 37, 512])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_apply_on_card_matches_cpu(dev, no_tf32, S, with_state):
    """Mamba2 (the chunked SSD scan, chunks of 128) at zamba2-2.7b's head
    layout with a narrow d_model, float32: the card against the CPU, output
    and states at 1e-5 of each one's largest entry (float32 summation
    order), and the card's bf16 forward finite."""
    from repro_torch.models import layers
    from repro_torch.tree import tree_map

    cfg = layers.Mamba2Config(d_model=256, d_state=64, head_dim=64)
    params = layers.mamba2_init(torch.Generator().manual_seed(4), cfg)
    rng = np.random.default_rng(S)
    x = torch.from_numpy(rng.normal(0, 1, (2, S, 256)).astype(np.float32))
    st = cv = None
    if with_state:
        st = torch.from_numpy(rng.normal(0, 0.3, (2, cfg.num_heads, 64, 64)).astype(np.float32))
        cv = torch.from_numpy(rng.normal(0, 1, (2, 3, cfg.d_inner + 128)).astype(np.float32))
    out = {}
    for d in (dev, torch.device("cpu")):
        mv = (lambda t: None if t is None else t.to(d))
        out[d.type] = layers.mamba2_apply(tree_map(mv, params), cfg, x.to(d), mv(st), mv(cv),
                                          chunk=128)
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a.cpu(), b, atol=1e-5 * max(1.0, float(b.abs().max())), rtol=0)
    pb = layers.mamba2_init(torch.Generator(device=dev).manual_seed(4), cfg, torch.bfloat16, device=dev)
    assert pb["A_log"].dtype == pb["D"].dtype == pb["dt_bias"].dtype == torch.float32
    y, _, _ = layers.mamba2_apply(pb, cfg, x.to(dev).bfloat16(), chunk=128)
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()


@pytest.mark.parametrize("tokens", [4096, 8])  # the grouped path (16 groups) and the flat path
def test_moe_on_card_matches_cpu_and_repeats(dev, no_tf32, tokens):
    """A MoE layer at deepseek's routing (64 experts, top 6, 16 groups,
    capacity_factor 1.25, so assignments drop) and a narrow width: the card's
    routing integers equal the CPU's, its float32 output the CPU's at 1e-5 of
    the largest, and a bf16 call repeats bit for bit (the combine is a gather
    and a sum over K, with no atomics)."""
    from repro_torch.models import layers
    from repro_torch.tree import tree_map

    cfg = layers.MoEConfig(d_model=128, d_ff_expert=64, num_experts=64, top_k=6, num_shared=2,
                           groups=16)
    params = layers.moe_init(torch.Generator().manual_seed(3), cfg)
    x = torch.from_numpy(np.random.default_rng(3).normal(0, 1, (tokens // 8, 8, 128)).astype(np.float32))
    G = 16 if layers.moe_grouped(cfg, tokens) else 1
    runs = {}
    for d in (dev, torch.device("cpu")):
        p = tree_map(lambda t: t.to(d), params)
        r = layers.moe_routing(p, cfg, x.to(d).reshape(-1, 128), G)
        runs[d.type] = (r, layers.moe_apply(p, cfg, x.to(d)), p)
    (rg, (og, ag), pg), (rc, (oc, ac), _) = runs["cuda"], runs["cpu"]
    for name in ("expert_ids", "pos", "keep"):
        assert torch.equal(getattr(rg, name).cpu(), getattr(rc, name)), name
    assert bool((~rc.keep).any())
    torch.testing.assert_close(og.cpu(), oc, atol=1e-5 * float(oc.abs().max()), rtol=0)
    torch.testing.assert_close(ag.cpu(), ac, atol=1e-6, rtol=0)
    pb = dict(tree_map(lambda t: t.bfloat16(), pg), router=pg["router"])  # the router stays float32
    xb = x.to(dev).bfloat16()
    assert torch.equal(layers.moe_apply(pb, cfg, xb)[0], layers.moe_apply(pb, cfg, xb)[0])


# ------------------------------------------------------------------ gradients and caches (LM)


def _grads(fn, ins, upstream):
    ins = [t.detach().requires_grad_() for t in ins]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    got = torch.autograd.grad(outs[:len(upstream)], ins, upstream, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for x, g in zip(ins, got)]


@pytest.mark.parametrize("route,dtype,B,S,H,K,D", [
    ("wgmma", torch.bfloat16, 2, 512, 28, 4, 128),  # qwen2-7b's training shape, GQA 7
    ("simt", torch.float32, 2, 128, 4, 2, 32),
    ("wgmma", torch.bfloat16, 2, 512, 32, 32, 80),  # zamba2-2.7b's training shape, D = 80
    ("simt", torch.float32, 2, 128, 4, 2, 80),
])
@pytest.mark.parametrize("window", [0, 32])
def test_flash_sdpa_function_gradients_match_plain_on_card(dev, route, dtype, B, S, H, K, D, window):
    """The Function's forward launches the route, its backward differentiates
    the plain version on the saved inputs: the gradients are plain autograd's
    (held at 1e-6 of the largest |g|)."""
    rng = np.random.default_rng(S + D + window)
    q, k, v = _flash_inputs(rng, B, S, S, H, K, D, dev, dtype)
    g = torch.tensor(rng.normal(0, 1, (B, S, H, D)).astype(np.float32), device=dev).to(dtype)
    got = _route_launches(route, lambda: _grads(lambda *a: flash_sdpa(*a, window=window),
                                                (q, k, v), (g,)))
    want = _grads(lambda *a: flash_sdpa_ref(*a, window=window), (q, k, v), (g,))
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.isfinite(a.float()).all()
        torch.testing.assert_close(a.float(), b.float(), atol=1e-6 * float(b.float().abs().max()),
                                   rtol=0)


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("upstream", ["out", "both"])
def test_wkv6_function_gradients_match_plain_on_card(dev, xdt, upstream):
    rng = np.random.default_rng(5)
    B, T, H, K = 2, 40, 3, 64

    def arr(shape, scale=1.0):
        return torch.tensor(rng.normal(0, scale, shape).astype(np.float32), device=dev)

    w = torch.tensor(rng.uniform(0.5, 0.99, (B, T, H, K)).astype(np.float32), device=dev)
    ins = (arr((B, T, H, K)).to(xdt), arr((B, T, H, K)).to(xdt), arr((B, T, H, K)).to(xdt), w,
           arr((H, K), 0.2), arr((B, H, K, K), 0.1))
    up = (arr((B, T, H, K)), arr((B, H, K, K)))[:1 if upstream == "out" else 2]
    before = wkv6.launches
    got = _grads(wkv6, ins, up)
    assert wkv6.launches == before + 1
    for a, b in zip(got, _grads(wkv6_ref, ins, up)):
        assert a.dtype == b.dtype and torch.isfinite(a.float()).all()
        torch.testing.assert_close(a.float(), b.float(), atol=1e-6 * float(b.float().abs().max()),
                                   rtol=0)


def test_kernels_without_gradient_raise_on_card(dev):
    """estimator_mlp, score_pipeline and iou_matrix(_batch) give no gradient:
    a CUDA input that requires grad raises under grad mode, and runs under
    torch.no_grad()."""
    rng = np.random.default_rng(6)
    w1, b1, w2, b2 = mlp(rng, F, 32, dev)
    x = torch.tensor(rng.normal(0, 1, (4, F)).astype(np.float32), device=dev)
    a = torch.tensor(boxes(rng, (2, 8)), device=dev)
    det = DetectionsBatch(boxes=a, scores=torch.rand((2, 8), device=dev),
                          classes=torch.zeros((2, 8), dtype=torch.int32, device=dev),
                          mask=torch.ones((2, 8), dtype=torch.bool, device=dev))
    params = {"w1": w1, "b1": b1, "w2": w2, "b2": b2, "mu": torch.zeros(F, device=dev),
              "sigma": torch.ones(F, device=dev)}
    calls = {
        "estimator_mlp": lambda: estimator_mlp(x.detach().requires_grad_(), w1, b1, w2, b2),
        "score_pipeline": lambda: score_pipeline(det, dict(params, b1=b1.detach().requires_grad_()),
                                                 num_classes=NUM_CLASSES, top_k=TOP_K),
        "iou_matrix": lambda: iou_matrix(a[0].detach().requires_grad_(), a[1]),
        "iou_matrix_batch": lambda: iou_matrix_batch(a, a.detach().requires_grad_()),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name} has no gradient"):
            call()
        with torch.no_grad():
            assert not call().requires_grad


def test_kv_quantize_on_card_bit_equal_to_cpu(dev):
    from repro_torch.models.layers import kv_quantize

    rng = np.random.default_rng(7)
    k = rng.normal(0, 2, (8, 64, 4, 128)).astype(np.float32)
    k[0, 0] = 0.0
    k[1, 1, 0] = np.tile(np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5], np.float32), 16)
    for dt in (torch.float32, torch.bfloat16):
        kt = torch.from_numpy(k).to(dt)
        (gq, gs), (wq, ws) = kv_quantize(kt.to(dev)), kv_quantize(kt)
        assert torch.equal(gq.cpu(), wq) and torch.equal(gs.cpu(), ws)


@pytest.mark.parametrize("window,kv_quant", [(8, False), (0, True), (8, True)])
def test_ring_and_int8_decode_on_card_match_cpu(dev, no_tf32, window, kv_quant):
    """A reduced float32 qwen2-7b: prefill of 12 tokens (into a ring of 8
    slots for window 8), then decode past the boundary, on the card against
    the CPU (2e-4 / 5e-4, the CPU tests' tolerances against repro)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = dataclasses.replace(lm.reduced(get_config("qwen2_7b")), window=window, kv_quant=kv_quant)
    params = lm.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12)))
    C = window or 16
    runs = {}
    for d in (dev, torch.device("cpu")):
        p = lm.tree_map(lambda t: t.to(d), params)
        last, cache = lm.prefill(p, cfg, {"tokens": toks.to(d)}, capacity=C)
        out, nxt = [last], last.argmax(-1)
        for pos in range(12, 15):
            logits, cache = lm.decode_step(p, cfg, cache, nxt.to(d), pos)
            out.append(logits)
            nxt = logits.argmax(-1)
        runs[d.type] = out
    for i, (a, b) in enumerate(zip(runs["cuda"], runs["cpu"])):
        torch.testing.assert_close(a.cpu(), b, atol=2e-4 if i == 0 else 5e-4, rtol=0)


@pytest.mark.parametrize("arch", ["qwen2_7b", "rwkv6_1b6", "deepseek_moe_16b", "deepseek_v2_lite_16b",
                                  "qwen2_vl_2b", "zamba2_2b7", "whisper_base"])
def test_lm_train_steps_on_card_match_cpu(dev, no_tf32, arch):
    """make_train_step on a reduced float32 model, card against CPU from one
    start: losses at 1e-4 relative, parameters within 2 lr_sum, at most 1%
    of elements beyond 1e-5 (tests/test_torch_train.py's criterion)."""
    from repro_torch.configs import get_config
    from repro_torch.data.lm_synth import synth_lm_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.train.adamw import adamw_init

    cfg, steps, lr = lm.reduced(get_config(arch)), 3, 1e-3
    start = lm.init_params(cfg, torch.Generator().manual_seed(2), device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(2)
    batches = [synth_lm_batch(rng, 2, 32, cfg.vocab_size) for _ in range(steps)]
    runs = {}
    for d in (dev, torch.device("cpu")):
        params = lm.tree_map(lambda t: t.to(d), start)
        opt, step, losses = adamw_init(params), make_train_step(cfg, lr=lr), []
        for toks, labels in batches:
            b = {"tokens": torch.from_numpy(toks).to(d), "labels": torch.from_numpy(labels).to(d),
                 **_modality_fields(cfg, 2, 32, d)}
            params, opt, loss = step(params, opt, b)
            losses.append(float(loss))
        runs[d.type] = (list(lm.tree_leaves(params)), losses)
    np.testing.assert_allclose(runs["cuda"][1], runs["cpu"][1], rtol=1e-4)
    far = total = 0
    for a, b in zip(*(runs[k][0] for k in ("cuda", "cpu"))):
        d = (a.cpu() - b).abs()
        assert float(d.max()) <= 2 * steps * lr
        far += int((d > 1e-5).sum())
        total += d.numel()
    assert far <= 0.01 * total, (far, total)


@pytest.fixture
def no_tf32():
    """Full float32 convolutions and products, as chip_smoke.py sets them."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def test_train_detector_on_card_matches_cpu(dev, no_tf32):
    """A few AdamW steps at reduced width from one seeded start (drawn on
    the CPU) on the card and on the CPU: loss traces at 1e-4 relative, every
    weight within 2 lr_sum, at most 1% of them beyond 1e-5 (the tolerance
    the port is held to against repro, tests/test_torch_train.py)."""
    from repro_torch.data.shapes import ShapesDataset
    from repro_torch.models.detector import DetectorConfig
    from repro_torch.train.schedule import warmup_cosine
    from repro_torch.train.trainer import train_detector

    cfg = DetectorConfig("tiny", widths=(8, 16, 16), head_width=16)
    ds = ShapesDataset.generate(96, seed=3)
    card, card_loss = train_detector(cfg, ds, steps=6, batch_size=32, log_every=0, device=dev)
    cpu, cpu_loss = train_detector(cfg, ds, steps=6, batch_size=32, log_every=0, device="cpu")
    np.testing.assert_allclose(card_loss, cpu_loss, rtol=1e-4)
    sched = warmup_cosine(3e-3, 1, 6)
    lr_sum = sum(sched(i) for i in range(6))
    far = total = 0
    for k, w in cpu.state_dict().items():
        d = (card.state_dict()[k].cpu() - w).abs()
        assert float(d.max()) <= 2 * lr_sum, k
        far, total = far + int((d > 1e-5).sum()), total + d.numel()
    assert far <= 0.01 * total


def test_engine_fit_on_card_matches_cpu(dev, no_tf32):
    """A short fit (3 epochs) of the reward estimator on the card and on the
    CPU from one start and the same features: calibration estimates (one
    estimator_mlp launch on the card) within 1e-4, decisions equal."""
    from repro_torch.api import MLPRewardModel, OffloadEngine
    from repro_torch.core.estimator import EstimatorConfig

    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (600, F)).astype(np.float32) * (rng.uniform(0, 1, F) < 0.5)
    rewards = rng.normal(0, 1, 600) * (rng.uniform(0, 1, 600) < 0.4)

    def fit(device):
        model = MLPRewardModel(config=EstimatorConfig(hidden=(128,), epochs=3), device=device)
        return OffloadEngine(reward_model=model, ratio=0.2, device=device).fit(
            features=torch.tensor(x, device=device), rewards=rewards)

    before = estimator_mlp.launches
    card = fit(dev)
    assert estimator_mlp.launches == before + 1 and card.reward_model.fused
    cpu = fit("cpu")
    np.testing.assert_allclose(card.calibration_scores, cpu.calibration_scores, atol=1e-4)
    np.testing.assert_array_equal(card.decide(features=x).offload, cpu.decide(features=x).offload)


def _detection_engine(device, rng_seed=11):
    """A detection engine (box features + the fused MLP, H 128) fitted for
    3 epochs on seeded detections, on ``device``."""
    from repro_torch.api import DetectionBoxFeatures, MLPRewardModel, OffloadEngine
    from repro_torch.core.estimator import EstimatorConfig

    rng = np.random.default_rng(rng_seed)
    batch = _seeded_detections(rng, 300, 64, device)
    model = MLPRewardModel(config=EstimatorConfig(hidden=(128,), epochs=3), device=device)
    engine = OffloadEngine(
        feature_extractor=DetectionBoxFeatures(NUM_CLASSES, TOP_K, image_size=64.0, device=device),
        reward_model=model, ratio=0.2, device=device)
    return engine.fit(batch, rewards=rng.normal(0, 1, 300))


def _seeded_detections(rng, B, K, device):
    counts = rng.integers(0, K + 1, B)
    mask = np.arange(K)[None] < counts[:, None]
    return DetectionsBatch(
        boxes=torch.tensor(boxes(rng, (B, K)), device=device),
        scores=torch.tensor(rng.uniform(0, 1, (B, K)).astype(np.float32), device=device),
        classes=torch.tensor(np.where(mask, rng.integers(0, NUM_CLASSES, (B, K)), -1), device=device),
        mask=torch.tensor(mask, device=device),
    )


def test_session_buffer_on_card_grows_and_compacts(dev, no_tf32, tmp_path):
    """The pending buffer lives on the card, grows geometrically past 64
    rows and compacts a partial drain (overlapping rows) correctly: the
    stream decides as the same engine on the CPU (estimates 1e-5, decisions
    equal away from the threshold), one estimator_mlp launch a drain."""
    from repro_torch.api import OffloadEngine
    from repro_torch.runtime import OffloadSession

    engine = _detection_engine(dev)
    engine.save(str(tmp_path / "engine.npz"))
    cpu = OffloadEngine.load(str(tmp_path / "engine.npz"), device="cpu")
    x = engine.features(_seeded_detections(np.random.default_rng(2), 150, 64, dev))
    sessions = [OffloadSession(engine, micro_batch=7), OffloadSession(cpu, micro_batch=7)]
    before = estimator_mlp.launches
    out = []
    for s, feats in zip(sessions, (x, x.cpu())):
        got = s.submit_batch(features=feats[:100], flush=False)  # 14 drains, 2 rows left
        assert s._buf.device == feats.device and s._buf.shape[0] == 100 and s._pending_rows == 2
        got += s.submit_batch(features=feats[100:], flush=False)  # 7 drains, 3 left
        assert s._buf.shape[0] == 100 and s._pending_rows == 3
        torch.testing.assert_close(s._buf[:3], feats[147:150], atol=0, rtol=0)
        out.append(got + s.flush())
    assert estimator_mlp.launches == before + 22
    card, host = out
    assert [d.step for d in card] == list(range(150)) == [d.step for d in host]
    est_c, est_h = (np.array([d.estimate for d in o]) for o in out)
    np.testing.assert_allclose(est_c, est_h, atol=1e-5, rtol=0)
    near = np.abs(est_h - engine.policy.threshold) <= 1e-5
    flips = np.array([a.offload != b.offload for a, b in zip(card, host)])
    assert not (flips & ~near).any()


def test_session_fast_path_vs_buffered_on_card(dev, no_tf32):
    """One request through the fast path (one score_pipeline launch) and
    through the buffered path (feature extraction, then estimator_mlp a
    micro-batch): estimates within 1e-5 (the MLP tolerance; two kernels,
    two summation orders), decisions equal except rows that close to the
    threshold, counted."""
    from repro_torch.runtime import OffloadSession

    engine = _detection_engine(dev)
    batch = _seeded_detections(np.random.default_rng(4), 64, 64, dev)
    sp, em = score_pipeline.launches, estimator_mlp.launches
    fast = OffloadSession(engine, micro_batch=8).submit_batch(batch)
    assert (score_pipeline.launches, estimator_mlp.launches) == (sp + 1, em)
    buffered = OffloadSession(engine, micro_batch=8)
    slow = buffered.submit_batch(batch, flush=False) + buffered.flush()
    assert (score_pipeline.launches, estimator_mlp.launches) == (sp + 1, em + 8)
    est_f = np.array([d.estimate for d in fast])
    est_b = np.array([d.estimate for d in slow])
    np.testing.assert_allclose(est_b, est_f, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(est_f, engine.decide(batch).estimates)  # same kernel, same inputs
    near = np.abs(est_f - engine.policy.threshold) <= 1e-5
    flips = np.array([a.offload != b.offload for a, b in zip(fast, slow)])
    assert not (flips & ~near).any(), f"{int(flips.sum())} flips, {int(near.sum())} rows near"


def test_session_submit_needs_no_host_sync(dev, no_tf32):
    """A frame that does not fill the micro-batch enters the card buffer
    without waiting for the card (CUDA's sync debug mode raises on any
    synchronizing call); the drain waits once, for its estimates."""
    from repro_torch.runtime import OffloadSession

    engine = _detection_engine(dev)
    x = engine.features(_seeded_detections(np.random.default_rng(6), 16, 64, dev))
    single = _seeded_detections(np.random.default_rng(7), 1, 64, dev)
    session = OffloadSession(engine, micro_batch=8)
    session.submit(features=x[0])  # allocates the buffer
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for row in x[1:7]:
            assert session.submit(features=row) == []
        with pytest.raises(RuntimeError):
            session.submit(features=x[7])  # the drain copies estimates to the host
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert session._pending_rows == 8
    assert len(session.flush()) == 8
    assert len(session.submit(single)) == 0 and session._pending_rows == 1


def test_value_iteration_on_card_matches_ref(dev):
    """The value-iteration solve as float32 tensor sweeps on the card: within
    1e-4 of the Python oracle (tests/test_netsim.py's tolerance) and 1e-5 of
    the CPU solve; the ratio grid's sweep as each single solve."""
    from repro_torch.netsim import (
        quantile_threshold,
        solve_value_iteration,
        value_iteration_ref,
        value_iteration_sweep,
    )
    from repro_torch.netsim.policy import _estimate_bins

    cal = np.random.default_rng(5).uniform(0, 1, 400)
    bins = _estimate_bins(cal, 32)
    for r in (0.1, 0.35, 0.7):
        lam = quantile_threshold(cal, r)
        V, theta = solve_value_iteration(bins, lam, device=dev)
        rV, rtheta = value_iteration_ref(bins, lam)
        np.testing.assert_allclose(theta, rtheta, atol=1e-4)
        np.testing.assert_allclose(V, rV, atol=1e-4)
        np.testing.assert_allclose(theta, solve_value_iteration(bins, lam, device="cpu")[1],
                                   atol=1e-5)
    grid = value_iteration_sweep(cal, (0.1, 0.35, 0.7), device=dev)
    np.testing.assert_allclose(grid, value_iteration_sweep(cal, (0.1, 0.35, 0.7), device="cpu"),
                               atol=1e-5)


def test_adaptive_feeding_svm_on_card_matches_cpu(dev, no_tf32):
    """The SVM's full-batch hinge fit on the card and on the CPU: weights
    within 1e-4, masks equal away from the decision boundary."""
    from repro_torch.core import AdaptiveFeedingSVM

    rng = np.random.default_rng(8)
    x = rng.normal(0, 1, (400, F)).astype(np.float32) * (rng.uniform(0, 1, F) < 0.5)
    x[:16] = x[0]
    difficult = rng.uniform(size=400) < 0.3
    for c_plus in (0.125, 2.0):
        card = AdaptiveFeedingSVM(c_plus=c_plus, epochs=60, device=dev).fit(x, difficult)
        cpu = AdaptiveFeedingSVM(c_plus=c_plus, epochs=60, device="cpu").fit(x, difficult)
        np.testing.assert_allclose(card.w, cpu.w, atol=1e-4)
        far = np.abs(cpu.decision(x)) >= 1e-3
        np.testing.assert_array_equal(card.predict(x)[far], cpu.predict(x)[far])


def test_cascade_from_engine_on_card(dev, no_tf32):
    """``Cascade.from_engine`` over one-frame blocks: one score_pipeline
    launch an item, estimates equal to the engine's whole-batch decide
    (the same kernel) within 1e-5, decisions equal away from the
    threshold."""
    from repro_torch.core import Cascade

    engine = _detection_engine(dev)
    batch = _seeded_detections(np.random.default_rng(9), 24, 64, dev)
    frames = [DetectionsBatch(boxes=batch.boxes[i : i + 1], scores=batch.scores[i : i + 1],
                              classes=batch.classes[i : i + 1], mask=batch.mask[i : i + 1])
              for i in range(24)]
    sp = score_pipeline.launches
    records = Cascade.from_engine(frames.__getitem__, lambda i: i, engine).run(range(24))
    assert score_pipeline.launches == sp + 24
    want = engine.decide(batch)
    est = np.array([r.estimate for r in records])
    np.testing.assert_allclose(est, want.estimates, atol=1e-5, rtol=0)
    near = np.abs(want.estimates - engine.policy.threshold) <= 1e-5
    off = np.array([r.offloaded for r in records])
    np.testing.assert_array_equal(off[~near], want.offload[~near])


@pytest.mark.parametrize("policy", ["queue_aware", "value_iteration"])
def test_linked_fleet_simulate_on_card_matches_cpu(dev, no_tf32, tmp_path, policy):
    """A seeded simulate over default_linked_fleet on the card and on the
    CPU (the engine artifact loaded there): estimates within 1e-5, records
    equal up to the first decision that flipped near the threshold."""
    from repro_torch.api import OffloadEngine
    from repro_torch.runtime import default_linked_fleet, simulate

    engine = _detection_engine(dev).with_policy(policy)
    engine.save(str(tmp_path / "engine.npz"))
    cpu = OffloadEngine.load(str(tmp_path / "engine.npz"), device="cpu").with_policy(policy)
    if policy == "value_iteration":
        assert engine.policy.device.type == "cuda"
        np.testing.assert_allclose(engine.policy.theta, cpu.policy.theta, atol=1e-5)
    x = engine.features(_seeded_detections(np.random.default_rng(3), 200, 64, dev))
    kw = dict(ratio=0.3, micro_batch=8, seed=0)
    card = simulate(engine, features=x, edges=default_linked_fleet(3, seed=0), **kw)
    host = simulate(cpu, features=x.cpu(), edges=default_linked_fleet(3, seed=0), **kw)
    est_c = np.array([r.estimate for r in card.records])
    est_h = np.array([r.estimate for r in host.records])
    np.testing.assert_allclose(est_c, est_h, atol=1e-5, rtol=0)
    flips = np.flatnonzero([a.offload != b.offload for a, b in zip(card.records, host.records)])
    upto = int(flips[0]) if flips.size else len(card.records)
    for a, b in zip(card.records[:upto], host.records[:upto]):
        a, b = a.as_dict(), b.as_dict()
        a.pop("estimate"), b.pop("estimate")
        assert a == b
    assert any(r.transmit_delay for r in card.records if r.transmit_delay is not None)


@pytest.mark.parametrize("B,T,p_cut", [(8, 48, 0.05), (3, 20, 0.2)])
def test_video_tracker_on_card_matches_cpu(dev, B, T, p_cut):
    """The tracker on the card: one matrix-route launch of iou_matrix_batch
    a step (B streams x the clip's K slots x 16 tracks), the association
    fields equal the CPU's exactly, boxes / vel / conf within 1e-6; the
    streaming tracker the same."""
    from repro_torch.video import (
        SceneConfig, VideoTracker, generate_clip, synthesize_detections, track_clip,
    )

    weak = synthesize_detections(generate_clip(B, T, seed=11, config=SceneConfig(p_cut=p_cut)),
                                 seed=12)
    key = f"matrix B={B} K={weak.max_boxes} M=16"
    shapes_before = iou_matrix_batch.launches_by_shape.get(key, 0)
    before = _route_counts()
    card = track_clip(weak, device=dev)
    after = _route_counts()
    assert after["iou_matrix_batch"]["matrix"] - before["iou_matrix_batch"]["matrix"] == T
    assert iou_matrix_batch.launches_by_shape[key] - shapes_before == T
    host = track_clip(weak, device="cpu")
    for f in ("ids", "active", "classes", "age", "det_track", "n_active", "n_matched", "n_new",
              "n_dead"):
        np.testing.assert_array_equal(getattr(card, f), getattr(host, f), err_msg=f)
    for f in ("boxes", "vel", "conf"):
        np.testing.assert_allclose(getattr(card, f), getattr(host, f), atol=1e-6, rtol=0, err_msg=f)
    vt = VideoTracker(B, device=dev)
    for t in range(T):
        tf = vt.update(weak.frame(t, device=dev))
    np.testing.assert_array_equal(tf.ids, host.ids[-1])
    np.testing.assert_allclose(tf.boxes, host.boxes[-1], atol=1e-6, rtol=0)


def test_serve_clip_on_card_matches_cpu(dev, no_tf32, tmp_path):
    """A small video scenario fitted on the card, served on the card and (its
    artifact) on the CPU: estimates within 1e-5, records equal up to the
    first decision that flipped; a second card serve is bit-identical."""
    import dataclasses

    from repro_torch.api import OffloadEngine
    from repro_torch.video import default_video_scenario, run_video_scenario

    scn = default_video_scenario(3, 32, seed=1, calibration_frames=16, device=dev)
    scn.engine.save(str(tmp_path / "engine.npz"))
    cpu = dataclasses.replace(scn, engine=OffloadEngine.load(str(tmp_path / "engine.npz"),
                                                             device="cpu"))
    card = run_video_scenario(scn, "temporal_hysteresis", ratio=0.3)
    again = run_video_scenario(scn, "temporal_hysteresis", ratio=0.3)
    host = run_video_scenario(cpu, "temporal_hysteresis", ratio=0.3)
    assert [s.records for s in card.streams] == [s.records for s in again.streams]
    for t in range(card.n_frames):
        rows = [(c.records[t].as_dict(), h.records[t].as_dict())
                for c, h in zip(card.streams, host.streams)]
        for a, b in rows:
            assert abs(a.pop("estimate") - b.pop("estimate")) <= 1e-5
        if any(a["offload"] != b["offload"] for a, b in rows):
            break
        assert all(a == b for a, b in rows)


# ---------------------------------------------------- the sharded fleet plane


def _fused_engine(dev, F_in, H, rows=256, seed=0):
    """A fused engine fitted on ``dev`` (2 epochs) on seeded features."""
    from repro_torch.api import MLPRewardModel, OffloadEngine
    from repro_torch.core.estimator import EstimatorConfig

    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (rows, F_in)).astype(np.float32)
    eng = OffloadEngine(reward_model=MLPRewardModel(
        config=EstimatorConfig(hidden=(H,), epochs=2, batch_size=64), device=dev))
    eng.fit(features=x, rewards=rng.normal(0, 1, rows))
    assert eng.reward_model.fused
    return eng, np.random.default_rng(seed + 1).normal(0, 1, (2000, F_in)).astype(np.float32)


def _synth_dets(rng, n, kmax=64, num_classes=NUM_CLASSES, size=64.0):
    from repro_torch.detection.map_engine import Detections, GroundTruth

    dets, gts = [], []
    for _ in range(n):
        k, m = int(rng.integers(0, kmax + 1)), int(rng.integers(1, 9))
        b = [rng.uniform(0, size - 25, (c, 2)) for c in (k, m)]
        wh = [rng.uniform(5, 20, (c, 2)) for c in (k, m)]
        dets.append(Detections(np.concatenate([b[0], b[0] + wh[0]], 1).astype(np.float32),
                               rng.uniform(0.1, 1.0, k).astype(np.float32),
                               rng.integers(0, num_classes, k).astype(np.int32)))
        gts.append(GroundTruth(np.concatenate([b[1], b[1] + wh[1]], 1).astype(np.float32),
                               rng.integers(0, num_classes, m).astype(np.int32)))
    return dets, gts


@pytest.mark.parametrize("B", [7, 64, 250])
def test_fleet_plane_score_on_card_bit_identical(dev, no_tf32, B):
    """Four logical shards of one card, each launched on the global batch's
    plan: bit for bit ``engine.score`` at the deployable head (B 64: the
    global plan runs clusters of 2, a shard planned alone clusters of 4)."""
    from repro_torch.fleet import FleetPlane
    from repro_torch.launch.mesh import make_fleet_mesh

    eng, x = _fused_engine(dev, F, 128)
    plane = FleetPlane(make_fleet_mesh(devices=[dev] * 4))
    before = estimator_mlp.launches
    out = plane.score(eng, x[:B])
    assert estimator_mlp.launches - before == 4
    assert np.array_equal(out, eng.score(features=x[:B]))


def test_fleet_shard_on_its_own_plan_differs_on_card(dev, no_tf32):
    """The reason for ``plan=``: B 64 at F 387 H 128 plans clusters of 2;
    each shard of 16 planned for itself runs clusters of 4, which splits F
    over 4 ranks and orders each row's sums differently; some rows then
    differ in their last bits from the whole batch's launch, while the
    shards on the global plan equal it."""
    from repro_torch.kernels.estimator_mlp.ops import head_plan

    rng = np.random.default_rng(3)
    w = mlp(rng, F, 128, dev)
    x = torch.tensor(rng.normal(0, 1, (64, F)).astype(np.float32), device=dev)
    whole = estimator_mlp(x, *w)
    g = head_plan(64, F, 128, dev)
    own = torch.cat([estimator_mlp(x[i:i + 16], *w) for i in range(0, 64, 16)])
    shared = torch.cat([estimator_mlp(x[i:i + 16], *w, plan=g) for i in range(0, 64, 16)])
    assert (g.cs, head_plan(16, F, 128, dev).cs) == (2, 4)
    assert torch.equal(shared, whole)
    assert not torch.equal(own, whole)
    torch.testing.assert_close(own, whole, atol=1e-5, rtol=0)


@pytest.mark.parametrize("B", [13, 150])
def test_fleet_plane_detections_on_card_bit_identical(dev, no_tf32, B):
    """``score_detections`` (one ``score_pipeline`` launch a shard, on the
    global plan), ``match`` (one ``match`` launch a shard) and
    ``extract_features`` over four logical shards of the card: bit for bit
    the single-device calls."""
    from repro_torch.api import DetectionBoxFeatures, MLPRewardModel, OffloadEngine
    from repro_torch.core.estimator import EstimatorConfig
    from repro_torch.core.features import extract_features_batch
    from repro_torch.fleet import FleetPlane

    rng = np.random.default_rng(B)
    cal, _ = _synth_dets(rng, 120)
    fx = DetectionBoxFeatures(num_classes=NUM_CLASSES, top_k=TOP_K, image_size=64.0, device=dev)
    eng = OffloadEngine(feature_extractor=fx, reward_model=MLPRewardModel(
        config=EstimatorConfig(hidden=(128,), epochs=2, batch_size=64), device=dev))
    eng.fit(cal, rewards=rng.uniform(0, 1, 120))
    dets, gts = _synth_dets(rng, B)
    db = DetectionsBatch.from_list(dets, device=dev)
    gb = GroundTruthBatch.from_list(gts, device=dev)
    plane = FleetPlane([dev] * 4)
    before = score_pipeline.launches, iou_matrix_batch.launches_by_route["match"]
    out = plane.score_detections(eng, db)
    ref_match = match_batch(db, gb, (0.5, 0.75))
    got_match = plane.match(db, gb, (0.5, 0.75))
    assert score_pipeline.launches - before[0] == 4
    assert iou_matrix_batch.launches_by_route["match"] - before[1] == 5
    assert np.array_equal(out, eng.score_device(db).cpu().numpy())
    assert np.array_equal(got_match.tp, ref_match.tp)
    assert np.array_equal(got_match.match_gt, ref_match.match_gt)
    assert np.array_equal(plane.extract_features(db, NUM_CLASSES, TOP_K, 64.0),
                          extract_features_batch(db, NUM_CLASSES, TOP_K, 64.0).cpu().numpy())


@pytest.mark.parametrize("model", ["waypoint", "random_walk"])
def test_rollout_on_card_matches_reference(dev, model):
    """The motion rollout on the card against ``rollout_ref`` (numpy):
    waypoints exactly, the random walk within ``tests/test_mobility.py``'s
    1e-3 (float32 cos / sin); a repeat is bit-identical."""
    from repro_torch.mobility import MotionConfig, rollout, rollout_ref

    cfg = MotionConfig(model=model, area=(1200.0, 600.0), speed=14.0)
    card = rollout(cfg, 16, 160, seed=5, device=dev)
    ref = rollout_ref(cfg, 16, 160, seed=5)
    assert np.array_equal(card, rollout(cfg, 16, 160, seed=5, device=dev))
    if model == "waypoint":
        assert np.array_equal(card, ref)
    else:
        np.testing.assert_allclose(card, ref, atol=1e-3, rtol=0)


def test_fleet_plane_over_every_card_bit_identical(dev, no_tf32):
    """The plane over every visible card (``make_fleet_mesh()``; needs two
    or more): each shard's weights and rows are copied to its card, its
    launches run there, and the results gather on the first card, bit for
    bit the single-device calls."""
    from repro_torch.api import DetectionBoxFeatures, MLPRewardModel, OffloadEngine
    from repro_torch.core.estimator import EstimatorConfig
    from repro_torch.core.features import extract_features_batch
    from repro_torch.fleet import FleetPlane
    from repro_torch.launch.mesh import make_fleet_mesh

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA GPUs")
    plane = FleetPlane(make_fleet_mesh())
    assert plane.devices == [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    rng = np.random.default_rng(11)
    cal, _ = _synth_dets(rng, 200)
    fx = DetectionBoxFeatures(num_classes=NUM_CLASSES, top_k=TOP_K, image_size=64.0, device=dev)
    eng = OffloadEngine(feature_extractor=fx, reward_model=MLPRewardModel(
        config=EstimatorConfig(hidden=(128,), epochs=2, batch_size=64), device=dev))
    eng.fit(cal, rewards=rng.uniform(0, 1, 200))
    for B in (7, 64, 250):
        dets, gts = _synth_dets(rng, B)
        db = DetectionsBatch.from_list(dets, device=dev)
        gb = GroundTruthBatch.from_list(gts, device=dev)
        x = extract_features_batch(db, NUM_CLASSES, TOP_K, 64.0).cpu().numpy()
        assert np.array_equal(plane.score(eng, x), eng.score(features=x)), B
        assert np.array_equal(plane.score_detections(eng, db),
                              eng.score_device(db).cpu().numpy()), B
        got, want = plane.match(db, gb, (0.5, 0.75)), match_batch(db, gb, (0.5, 0.75))
        assert np.array_equal(got.tp, want.tp) and np.array_equal(got.match_gt, want.match_gt)
        assert np.array_equal(plane.extract_features(db, NUM_CLASSES, TOP_K, 64.0), x), B
    # a city run over every card equals the one-card run record for record
    from repro_torch.fleet import default_city_scenario, run_city_scenario

    scn = default_city_scenario(256, 8, calibration_frames=512, estimator_epochs=2, device=dev)
    one = run_city_scenario(scn, coordinated=True, plane=FleetPlane([dev]))
    every = run_city_scenario(scn, coordinated=True, plane=plane)
    for a, b in zip(one.trace.steps, every.trace.steps):
        assert np.array_equal(a.estimates, b.estimates) and np.array_equal(a.offload, b.offload)
    assert one.trace.telemetry == every.trace.telemetry


def _mesh_check(world):
    """``chip_smoke.mesh_step_check``: qwen2-7b's prefill, 16 greedy decode
    steps and a 2-layer train step (tp and fsdp), sharded by the rules over
    the (1, world) mesh of NCCL ranks, held against the unbound path."""
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:  # the spawned ranks unpickle chip_smoke.mesh_rank by name
        sys.path.insert(0, root)
    import chip_smoke as smoke
    # build the flash routes once here, not in every rank at once
    for S in (512, 1):
        q = torch.zeros(1, S, 28, 128, dtype=torch.bfloat16, device="cuda")
        k = torch.zeros(1, 512, 4, 128, dtype=torch.bfloat16, device="cuda")
        flash_sdpa(q, k, k, q_offset=512 - S)
    report = smoke.mesh_step_check(world)
    print("mesh_step", json.dumps(report))  # the holds and times, for the record (-s)
    return report


def test_sharded_step_on_card_matches_unbound(dev, no_tf32):
    """World 1: every sharded result bit-equal to the unbound one, and the
    sharded path launched flash_sdpa."""
    r = _mesh_check(1)
    assert r["world"] == 1 and r["serve"]["tokens_equal"]
    assert r["serve"]["prefill_logits"] == {"bit_equal": True}
    assert all(step == {"bit_equal": True} for step in r["serve"]["step_logits"])
    assert r["train"]["tp"]["bit_equal"] and r["train"]["fsdp"]["bit_equal"]
    assert r["launches"]["flash_sdpa"] > 0


def test_sharded_step_over_every_card(dev, no_tf32):
    """One NCCL rank a card on (1, world): the prefill's and each decode
    step's logits (teacher-forced with the unbound path's tokens: a bf16
    near-tie of seeded weights flips a free run's argmax) and the loss
    within the lm phase's bf16 hold."""
    world = torch.cuda.device_count()
    if world < 2:
        pytest.skip("needs two or more CUDA GPUs")
    r = _mesh_check(world)
    assert r["world"] == world and r["serve"]["teacher_forced"]
    assert r["serve"]["prefill_logits"]["rel"] <= 0.05
    assert all(step["rel"] <= 0.05 for step in r["serve"]["step_logits"])
    for mode in ("tp", "fsdp"):
        assert r["train"][mode]["loss"]["rel"] <= 0.05
    assert r["launches"]["flash_sdpa"] > 0
