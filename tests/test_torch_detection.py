"""The port's detection plane against ``repro`` on the CPU: NMS keep masks,
batched greedy matching and the mAP it feeds are exactly equal."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from _torch_parity import both_detections, random_detection_arrays
from conftest import make_noisy_pair

from repro.detection.batch import (
    DetectionsBatch as JDB,
    GroundTruthBatch as JGB,
    match_batch as j_match,
    to_image_evals as j_evals,
)
from repro.detection.map_engine import APAccumulator as JAcc
from repro.detection.nms import nms as j_nms
from repro_torch.detection.batch import (
    DetectionsBatch as TDB,
    GroundTruthBatch as TGB,
    match_batch,
    to_image_evals,
)
from repro_torch.detection.map_engine import APAccumulator, GroundTruth, dataset_map
from repro_torch.detection.nms import nms, nms_batch

T2 = (0.5, 0.75)


def _nms_inputs(rng, n_images, n=64, tie_levels=8):
    b = rng.uniform(0, 48, (n_images, n, 2))
    boxes = np.concatenate([b, b + rng.uniform(4, 24, (n_images, n, 2))], -1).astype(np.float32)
    scores = (np.round(rng.uniform(0, 1, (n_images, n)) * tie_levels) / tie_levels).astype(np.float32)
    classes = rng.integers(0, 3, (n_images, n)).astype(np.int32)
    return boxes, scores, classes


@pytest.mark.parametrize("iou_thr,score_thr", [(0.45, 0.25), (0.5, 0.0), (0.3, 0.5)])
def test_nms_keep_masks_equal(iou_thr, score_thr):
    rng = np.random.default_rng(17)
    boxes, scores, classes = _nms_inputs(rng, 6)
    want = np.stack([
        np.asarray(j_nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), jnp.asarray(classes[i]),
                         iou_threshold=iou_thr, score_threshold=score_thr))
        for i in range(len(boxes))
    ])
    tb, ts, tc = (torch.tensor(v) for v in (boxes, scores, classes))
    per_image = torch.stack([
        nms(tb[i], ts[i], tc[i], iou_threshold=iou_thr, score_threshold=score_thr)
        for i in range(len(boxes))
    ])
    batched = nms_batch(tb, ts, tc, iou_threshold=iou_thr, score_threshold=score_thr)
    np.testing.assert_array_equal(per_image.numpy(), want)
    np.testing.assert_array_equal(batched.numpy(), want)
    assert want.any() and not want.all()


def _both_batches(gts, dets):
    jd = JDB.from_list(dets)
    jg = JGB.from_list(gts)
    td = TDB(boxes=jd.boxes, scores=jd.scores, classes=jd.classes, mask=jd.mask)
    tg = TGB(boxes=jg.boxes, classes=jg.classes, mask=jg.mask)
    return jd, jg, td, tg


@pytest.mark.parametrize("which", ["weak", "strong"])
def test_match_batch_equal(which):
    gts, weak, strong = make_noisy_pair(np.random.default_rng(7))
    jd, jg, td, tg = _both_batches(gts, weak if which == "weak" else strong)
    want = j_match(jd, jg, T2)
    got = match_batch(td, tg, T2)
    np.testing.assert_array_equal(got.tp, want.tp)
    np.testing.assert_array_equal(got.match_gt, want.match_gt)
    assert got.tp.dtype == bool and got.match_gt.dtype == np.int32
    assert got.tp.any()
    # the AP engine on top sees identical evaluations
    ja, ta = JAcc(T2), APAccumulator(T2)
    for ev in j_evals(jd, jg, want):
        ja.add(ev)
    for ev in to_image_evals(td, tg, got):
        ta.add(ev)
    assert ta.map() == ja.map()


def test_match_batch_tied_scores():
    rng = np.random.default_rng(3)
    arrays = random_detection_arrays(rng, 20, 30, 4, 0.1, tie_levels=3, scale=64.0)
    gts = [GroundTruth(a[0][: max(1, len(a[0]) // 3)] + 1.0, a[2][: max(1, len(a[0]) // 3)])
           for a in arrays]
    jdets, _ = both_detections(arrays)
    jd, jg, td, tg = _both_batches(gts, jdets)
    want = j_match(jd, jg, T2)
    got = match_batch(td, tg, T2)
    np.testing.assert_array_equal(got.tp, want.tp)
    np.testing.assert_array_equal(got.match_gt, want.match_gt)


def test_match_batch_zero_length():
    td, tg = TDB.from_list([], device="cpu"), TGB.from_list([], device="cpu")
    res = match_batch(td, tg, T2)
    want = j_match(JDB.from_list([]), JGB.from_list([]), T2)
    assert res.tp.shape == want.tp.shape == (0, 2, 8)
    assert res.match_gt.shape == want.match_gt.shape
    assert to_image_evals(td, tg, res) == []


def test_dataset_map_from_batched_matching():
    """to_image_evals -> APAccumulator equals the per-image numpy matcher
    (dataset_map) and repro's."""
    gts, weak, _ = make_noisy_pair(np.random.default_rng(11), n_images=30)
    jd, jg, td, tg = _both_batches(gts, weak)
    acc = APAccumulator(T2)
    for ev in to_image_evals(td, tg, match_batch(td, tg, T2)):
        acc.add(ev)
    host = dataset_map([td[i] for i in range(len(td))], [tg[i] for i in range(len(tg))], T2)
    assert acc.map() == pytest.approx(host, abs=1e-12)
    ja = JAcc(T2)
    for ev in j_evals(jd, jg, j_match(jd, jg, T2)):
        ja.add(ev)
    assert acc.map() == ja.map()


def test_masked_slots_are_ignored():
    """A batch that keeps every slot and marks the dropped ones in ``mask``
    (the on-card detector route) matches like the compacted from_list batch,
    whatever the dropped slots hold."""
    gts, weak, _ = make_noisy_pair(np.random.default_rng(5), n_images=12)
    jd, jg, td, tg = _both_batches(gts, weak)
    junk = TDB(
        boxes=torch.where(td.mask[..., None], td.boxes, torch.tensor(20.0)),
        scores=torch.where(td.mask, td.scores, torch.tensor(0.99)),
        classes=torch.where(td.mask, td.classes, torch.tensor(1, dtype=torch.int32)),
        mask=td.mask,
    )
    a, b = match_batch(td, tg, T2), match_batch(junk, tg, T2)
    np.testing.assert_array_equal(a.tp, b.tp)
    np.testing.assert_array_equal(a.match_gt, b.match_gt)


def test_batch_containers_round_trip():
    rng = np.random.default_rng(2)
    arrays = random_detection_arrays(rng, 5, 12)
    jdets, tdets = both_detections(arrays)
    db = TDB.from_list(tdets, device="cpu")
    assert db.max_boxes == JDB.from_list(jdets).max_boxes
    assert db.boxes.dtype == torch.float32
    assert db.classes.dtype == torch.int32 and db.mask.dtype == torch.bool
    for orig, back in zip(tdets, db.to_list()):
        np.testing.assert_array_equal(orig.boxes, back.boxes)
        np.testing.assert_array_equal(orig.scores, back.scores)
        np.testing.assert_array_equal(orig.classes, back.classes)
    padded = db.pad_images(8)
    assert len(padded) == 8 and not padded.mask[5:].any()
    assert (padded.classes[5:] == -1).all()
    with pytest.raises(ValueError, match="max_boxes"):
        TDB.from_list(tdets, max_boxes=2, device="cpu")
