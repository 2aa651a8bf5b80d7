"""The iou_matrix family's routes on the CPU: the plain versions of the
``nms`` and ``match`` routes against ``repro`` (exactly: bool / int results),
the launch plan ``iou_plan``, and numpy emulations of the kernels' two
serial algorithms (the suppression bitmask scan, the lane-split argmax)
against the plain versions.  The kernels themselves run in
``tests/test_torch_cuda.py`` on the card."""
import numpy as np
import pytest
import torch

import repro.detection.batch  # noqa: F401  (before repro.kernels: an import cycle)
import jax.numpy as jnp
from repro.detection.batch import DetectionsBatch as JDB
from repro.detection.batch import GroundTruthBatch as JGB
from repro.detection.batch import match_batch as j_match
from repro.detection.nms import nms as j_nms
from repro_torch.kernels.iou_matrix import (
    greedy_match,
    greedy_match_ref,
    iou_matrix,
    iou_matrix_batch,
    iou_plan,
    nms_keep,
    nms_keep_ref,
)
from repro_torch.kernels.iou_matrix.ops import (
    LIMITS,
    MATCH_FIELDS,
    MATRIX_FIELDS,
    NMS_FIELDS,
    ROUTES,
    SMEM_LIMIT,
    THREADS,
)

COCO = tuple(np.round(np.linspace(0.5, 0.95, 10), 2))


def _boxes(rng, shape, scale=48.0):
    xy = rng.uniform(0, scale, shape + (2,))
    return np.concatenate([xy, xy + rng.uniform(4, 24, shape + (2,))], -1).astype(np.float32)


def _nms_inputs(rng, B, N, pad=0):
    """Tied scores (multiples of 1/8), three classes; the last ``pad`` slots
    of each image are padding (class -1, score 0, zero box)."""
    boxes = _boxes(rng, (B, N))
    scores = (np.round(rng.uniform(0, 1, (B, N)) * 8) / 8).astype(np.float32)
    classes = rng.integers(0, 3, (B, N)).astype(np.int32)
    if pad:
        boxes[:, N - pad:] = 0.0
        scores[:, N - pad:] = 0.0
        classes[:, N - pad:] = -1
    return boxes, scores, classes


def _j_nms(boxes, scores, classes, iou_thr, score_thr):
    return np.stack([
        np.asarray(j_nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), jnp.asarray(classes[i]),
                         iou_threshold=iou_thr, score_threshold=score_thr))
        for i in range(len(boxes))
    ])


@pytest.mark.parametrize("N", [1, 63, 64, 65, 130])
@pytest.mark.parametrize("iou_thr,score_thr", [(0.45, 0.25), (0.5, 0.0)])
def test_nms_keep_ref_equals_reference(N, iou_thr, score_thr):
    rng = np.random.default_rng(N)
    boxes, scores, classes = _nms_inputs(rng, 3, N, pad=N // 5)
    want = _j_nms(boxes, scores, classes, iou_thr, score_thr)
    args = (torch.tensor(boxes), torch.tensor(scores), torch.tensor(classes), iou_thr, score_thr)
    got = nms_keep_ref(*args)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(nms_keep(*args).numpy(), want)  # the CPU path
    if N >= 63:
        assert want.any() and not want.all()


def test_nms_iou_exactly_at_threshold():
    """[0,0,2,1] against [0,0,1,1] has float32 IoU 0.5 exactly: at 0.5 the
    pair does not suppress (``>``), just below it does."""
    boxes = np.array([[[0, 0, 2, 1], [0, 0, 1, 1]]], np.float32)
    scores = np.array([[0.9, 0.8]], np.float32)
    classes = np.zeros((1, 2), np.int32)
    for thr, want in ((0.5, [[True, True]]), (0.49, [[True, False]])):
        np.testing.assert_array_equal(_j_nms(boxes, scores, classes, thr, 0.0), want)
        got = nms_keep_ref(torch.tensor(boxes), torch.tensor(scores), torch.tensor(classes), thr, 0.0)
        np.testing.assert_array_equal(got.numpy(), want)


def _match_inputs(rng, B, K, M, empty_images=1):
    """Detections near the ground truth (so that the thresholds split them),
    prefix masks, padding at class -1 with zero boxes, the first
    ``empty_images`` images without a detection."""
    gt = _boxes(rng, (B, M))
    g_classes = rng.integers(0, 2, (B, M)).astype(np.int32)
    if M:
        src = rng.integers(0, M, (B, K))
        det = np.take_along_axis(gt, src[..., None], 1) + rng.normal(0, 2.0, (B, K, 4))
        det[..., 2:] = np.maximum(det[..., 2:], det[..., :2] + 0.5)
        near = np.take_along_axis(g_classes, src, 1)
        d_classes = np.where(rng.uniform(0, 1, (B, K)) < 0.8, near, 1 - near)
    else:
        det, d_classes = _boxes(rng, (B, K)), rng.integers(0, 2, (B, K))
    d_scores = (np.round(rng.uniform(0, 1, (B, K)) * 8) / 8).astype(np.float32)
    d_mask = np.arange(K)[None] < rng.integers(1, K + 1, B)[:, None] if K else np.zeros((B, 0), bool)
    d_mask[:empty_images] = False
    g_mask = np.arange(M)[None] < rng.integers(1, M + 1, B)[:, None] if M else np.zeros((B, 0), bool)
    det = np.where(d_mask[..., None], det, 0).astype(np.float32)
    d_classes = np.where(d_mask, d_classes, -1).astype(np.int32)
    d_scores = np.where(d_mask, d_scores, 0).astype(np.float32)
    gt = np.where(g_mask[..., None], gt, 0).astype(np.float32)
    g_classes = np.where(g_mask, g_classes, -1).astype(np.int32)
    return det, d_scores, d_classes, d_mask, gt, g_classes, g_mask


def _match_both(arrays, thresholds):
    det, d_scores, d_classes, d_mask, gt, g_classes, g_mask = arrays
    want = j_match(JDB(boxes=det, scores=d_scores, classes=d_classes, mask=d_mask),
                   JGB(boxes=gt, classes=g_classes, mask=g_mask), thresholds)
    args = [torch.tensor(a) for a in arrays] + [torch.tensor(thresholds, dtype=torch.float32)]
    return want, greedy_match_ref(*args), greedy_match(*args)


@pytest.mark.parametrize("M", [1, 8, 32, 33])
@pytest.mark.parametrize("thresholds", [(0.5,), COCO])
def test_greedy_match_ref_equals_reference(M, thresholds):
    rng = np.random.default_rng(M + len(thresholds))
    want, ref, cpu = _match_both(_match_inputs(rng, 4, 64 if M > 1 else 5, M), thresholds)
    for tp, mj in (ref, cpu):
        assert tp.dtype == torch.bool and mj.dtype == torch.int32
        np.testing.assert_array_equal(tp.numpy(), want.tp)
        np.testing.assert_array_equal(mj.numpy(), want.match_gt)
    assert want.tp.any() and not want.tp[:, -1].all()
    assert not want.tp[0].any()  # the image without detections


@pytest.mark.parametrize("K,M", [(0, 8), (8, 0), (0, 0)])
def test_greedy_match_ref_empty_axes(K, M):
    """No detection or no GT slot: all misses (repro's matcher refuses an
    empty axis; the port's plain version keeps _greedy_match's answer)."""
    arrays = _match_inputs(np.random.default_rng(3), 3, K, M, empty_images=0)
    args = [torch.tensor(a) for a in arrays] + [torch.tensor(COCO, dtype=torch.float32)]
    for tp, mj in (greedy_match_ref(*args), greedy_match(*args)):
        assert tp.shape == mj.shape == (3, 10, K)
        assert not tp.any() and (mj == -1).all()


def test_greedy_match_iou_exactly_at_threshold():
    """IoU 0.5 exactly is a hit at 0.5 (``>=``) and a miss above it."""
    arrays = (np.array([[[0, 0, 1, 1]]], np.float32), np.array([[0.9]], np.float32),
              np.zeros((1, 1), np.int32), np.ones((1, 1), bool),
              np.array([[[0, 0, 2, 1]]], np.float32), np.zeros((1, 1), np.int32),
              np.ones((1, 1), bool))
    want, (tp, mj), _ = _match_both(arrays, (0.5, 0.55))
    np.testing.assert_array_equal(want.tp, [[[True], [False]]])
    np.testing.assert_array_equal(tp.numpy(), want.tp)
    np.testing.assert_array_equal(mj.numpy(), want.match_gt)


# ---------------------------------------------------------------- iou_plan


def _check_layout(plan, fields):
    names = [n for n, _ in plan.offsets]
    offs = [o for _, o in plan.offsets]
    assert names == list(fields)
    assert all(o % 16 == 0 for o in offs) and offs == sorted(offs)
    assert 0 < plan.smem <= SMEM_LIMIT and plan.smem % 16 == 0
    assert dict(plan.limits) == LIMITS[plan.route]


@pytest.mark.parametrize("N", [1, 63, 64, 65, 130, 1024])
def test_iou_plan_nms(N):
    plan = iou_plan("nms", N)
    _check_layout(plan, NMS_FIELDS)
    off = dict(plan.offsets)
    assert plan.words == -(-N // 64)
    assert off["keys"] - off["sup"] >= 8 * N * plan.words  # N rows of words
    assert plan.lanes * N <= max(THREADS, N) and plan.lanes in (1, 2, 4, 8)
    if N == 1024:
        assert plan.words == 16 and 8 * N * plan.words == 128 * 1024


@pytest.mark.parametrize("K,M,T", [(64, 8, 1), (64, 8, 2), (64, 1, 10), (5, 33, 10), (1024, 1024, 10),
                                   (2048, 1024, 64)])
def test_iou_plan_match(K, M, T):
    plan = iou_plan("match", K, M, T)
    _check_layout(plan, MATCH_FIELDS)
    off = dict(plan.offsets)
    assert 1 <= plan.rows <= K
    assert off["det_mask"] - off["tile"] >= 4 * plan.rows * M
    if (K, M) == (64, 8):  # the path: the whole tile in one chunk
        assert plan.rows == K and plan.smem < 48 * 1024


@pytest.mark.parametrize("K,M", [(64, 64), (1, 1), (64, 8), (511, 130), (70, 33), (3, 8192)])
def test_iou_plan_matrix(K, M):
    plan = iou_plan("matrix", K, M)
    _check_layout(plan, MATRIX_FIELDS)
    per_row = M // 4 if M % 4 == 0 else M
    assert plan.rows * per_row <= max(THREADS, per_row)
    assert plan.grid_rows * plan.rows >= K > (plan.grid_rows - 1) * plan.rows


@pytest.mark.parametrize("route,args,name", [
    ("nms", (1025,), "N"), ("match", (2049, 8, 1), "K"), ("match", (64, 1025, 1), "M"),
    ("match", (64, 8, 65), "T"), ("matrix", (4, 8193), "M"),
])
def test_iou_plan_refuses_past_limits(route, args, name):
    with pytest.raises(ValueError, match=f"{name} <= {LIMITS[route][name]}"):
        iou_plan(route, *args)


def test_route_counters_start_at_zero_on_cpu():
    """CPU tensors take the plain versions and launch nothing."""
    rng = np.random.default_rng(0)
    before = [dict(w.launches_by_route) for w in (iou_matrix, iou_matrix_batch)]
    assert all(set(b) == set(ROUTES) for b in before)
    boxes, scores, classes = (torch.tensor(a) for a in _nms_inputs(rng, 2, 16))
    nms_keep(boxes, scores, classes)
    iou_matrix_batch(boxes, boxes)
    assert [w.launches_by_route for w in (iou_matrix, iou_matrix_batch)] == before


# ---------------------------------------------------------------- emulations


def _rank(keys):
    """The kernels' stable rank: #{j : k_j > k_i or (k_j == k_i and j < i)}."""
    k = np.asarray(keys)
    j = np.arange(len(k))
    return ((k[None, :] > k[:, None]) | ((k[None, :] == k[:, None]) & (j[None] < j[:, None]))).sum(1)


def _emulate_nms(boxes, scores, classes, iou_thr, score_thr):
    """iou_nms.cu's algorithm on one image, 64-bit words as Python ints."""
    N = len(scores)
    W = -(-N // 64)
    rank = _rank(scores)
    order = np.argsort(rank)
    iou = iou_matrix(torch.tensor(boxes[order]), torch.tensor(boxes[order])).numpy()
    sup = np.zeros((N, W), object)
    for r in range(N):
        for j in range(r + 1, N):
            if classes[order[j]] == classes[order[r]] and iou[r, j] > np.float32(iou_thr):
                sup[r, j // 64] |= 1 << (j % 64)
    kw = [0] * W
    for r in range(N):
        if scores[order[r]] > np.float32(score_thr):
            kw[r // 64] |= 1 << (r % 64)
    for w in range(W):
        cur = kw[w]
        for bit in range(min(64, N - 64 * w)):  # lane w, in series
            if cur >> bit & 1:
                cur &= ~sup[64 * w + bit, w]
        kw[w] = cur
        for lane in range(w + 1, W):  # the later words drop word w's kept rows
            for bit in range(64):
                if cur >> bit & 1:
                    kw[lane] &= ~sup[64 * w + bit, lane]
    return np.array([bool(kw[r // 64] >> (r % 64) & 1) for r in map(int, rank)])


@pytest.mark.parametrize("N", [1, 64, 65, 130])
def test_bitmask_scan_emulation_equals_plain(N):
    rng = np.random.default_rng(100 + N)
    boxes, scores, classes = _nms_inputs(rng, 2, N, pad=N // 7)
    want = nms_keep_ref(torch.tensor(boxes), torch.tensor(scores), torch.tensor(classes), 0.45, 0.25)
    for b in range(2):
        np.testing.assert_array_equal(_emulate_nms(boxes[b], scores[b], classes[b], 0.45, 0.25),
                                      want[b].numpy())


def _emulate_match(det, d_scores, d_classes, d_mask, gt, g_classes, g_mask, thresholds):
    """iou_match.cu's algorithm on one image: GT slot m on lane m % 32, each
    lane's first maximum, then the xor butterfly with ties to the smaller
    slot."""
    K, M = len(d_scores), len(g_classes)
    order = np.argsort(_rank(np.where(d_mask, d_scores, -np.inf)))
    iou = iou_matrix(torch.tensor(det), torch.tensor(gt)).numpy()
    width = 1
    while width < M and width < 32:
        width *= 2
    tp = np.zeros((len(thresholds), K), bool)
    mg = np.full((len(thresholds), K), -1, np.int32)
    for t, thr in enumerate(np.asarray(thresholds, np.float32)):
        taken = np.zeros(M, bool)
        for s in order:
            lanes = [(-np.inf, 2**31 - 1)] * 32
            for m in range(M):
                ok = d_mask[s] and g_mask[m] and d_classes[s] == g_classes[m]
                v = -1.0 if taken[m] else (iou[s, m] if ok else -1.0)
                if v > lanes[m % 32][0]:
                    lanes[m % 32] = (v, m)
            off = 1
            while off < width:
                lanes = [max(lanes[ln], lanes[ln ^ off], key=lambda c: (c[0], -c[1]))
                         for ln in range(32)]
                off *= 2
            best, bj = lanes[0]
            if best >= thr:
                taken[bj] = True
                tp[t, s], mg[t, s] = True, bj
    return tp, mg


@pytest.mark.parametrize("M", [1, 8, 33])
def test_lane_argmax_emulation_equals_plain(M):
    rng = np.random.default_rng(200 + M)
    arrays = _match_inputs(rng, 2, 24, M)
    tp, mj = greedy_match_ref(*[torch.tensor(a) for a in arrays],
                              torch.tensor(COCO[:3], dtype=torch.float32))
    for b in range(2):
        got_tp, got_mj = _emulate_match(*[a[b] for a in arrays], COCO[:3])
        np.testing.assert_array_equal(got_tp, tp[b].numpy())
        np.testing.assert_array_equal(got_mj, mj[b].numpy())


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
def test_plain_versions_equal_repro_on_nan_boxes(side):
    """A box with a NaN coordinate has a NaN union, so its IoU is 0 in
    ``box_iou`` and in ``repro`` (the card's routes are held to these plain
    versions exactly in tests/test_torch_cuda.py).  NMS keeps, the matching
    and the fused score pipeline's NaN estimates equal ``repro``'s too."""
    from repro.kernels.iou_matrix import iou_matrix_batch as j_iou_batch
    from repro.kernels.score_pipeline import score_pipeline as j_score
    from repro_torch.kernels.iou_matrix import iou_matrix_batch_ref, iou_matrix_ref
    from repro_torch.kernels.score_pipeline import score_pipeline_ref

    first, second = side in ("first", "both"), side in ("second", "both")
    rng = np.random.default_rng(5)
    # the pair of the fault: [NaN, 0, 5, 10] against [0, 0, 10, 10]
    p, q = np.array([[np.nan, 0, 5, 10]], np.float32), np.array([[0, 0, 10, 10]], np.float32)
    p, q = (p, q) if first else (q, p)
    if first and second:
        q = p
    assert iou_matrix_ref(torch.tensor(p), torch.tensor(q)).tolist() == [[0.0]]

    a, g = _boxes(rng, (3, 8)), _boxes(rng, (3, 6))
    a, g = (_with_nan(a, NAN_AT) if first else a), (_with_nan(g, NAN_AT) if second else g)
    want = np.asarray(j_iou_batch(jnp.asarray(a), jnp.asarray(g)))
    np.testing.assert_array_equal(iou_matrix_batch_ref(torch.tensor(a), torch.tensor(g)).numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(j_iou_batch(jnp.asarray(a), jnp.asarray(g), interpret=True)), want)
    hit = np.zeros(want.shape, bool)
    for b, i, _ in NAN_AT:
        if first:
            hit[b, i, :] = True
        if second:
            hit[b, :, i] = True
    assert (want[hit] == 0).all() and (want[~hit] > 0).any()

    boxes, scores, classes = _nms_inputs(rng, 3, 64)
    boxes = _with_nan(boxes, [(b, int(np.argmax(scores[b])), j) for b, _, j in NAN_AT] + list(NAN_AT))
    want = _j_nms(boxes, scores, classes, 0.45, 0.25)
    np.testing.assert_array_equal(
        nms_keep_ref(torch.tensor(boxes), torch.tensor(scores), torch.tensor(classes), 0.45, 0.25).numpy(),
        want)

    arrays = list(_match_inputs(rng, 3, 64, 8, empty_images=0))
    at = [(b, 0, j) for b, _, j in NAN_AT]
    if first:
        arrays[0] = _with_nan(arrays[0], at)
    if second:
        arrays[4] = _with_nan(arrays[4], at)
    want, ref, _ = _match_both(tuple(arrays), COCO)
    np.testing.assert_array_equal(ref[0].numpy(), want.tp)
    np.testing.assert_array_equal(ref[1].numpy(), want.match_gt)

    det, d_scores, d_classes, d_mask = arrays[:4]
    F = 25 * (7 + 8) + 4 + 8
    params = {"w1": rng.normal(0, 0.1, (F, 32)), "b1": rng.normal(0, 0.1, 32),
              "w2": rng.normal(0, 0.1, 32), "b2": np.float64(0.05), "mu": rng.normal(0, 0.1, F),
              "sigma": rng.uniform(0.5, 2.0, F)}
    params = {k: np.asarray(v, np.float32) for k, v in params.items()}
    kw = dict(num_classes=8, top_k=25, image_size=64.0)
    want = np.asarray(j_score(JDB(boxes=det, scores=d_scores, classes=d_classes, mask=d_mask),
                              {k: jnp.asarray(v) for k, v in params.items()}, **kw))
    got = score_pipeline_ref(*(torch.tensor(x) for x in (det, d_scores, d_classes, d_mask)),
                             *(torch.tensor(params[k]) for k in ("w1", "b1", "w2", "b2", "mu", "sigma")),
                             64.0, 8, 25).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    assert np.isnan(want).any() == first
