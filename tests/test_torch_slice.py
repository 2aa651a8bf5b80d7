"""The detection serve path as a whole, in both packages on the CPU: seeded
shapes images -> weak detector + NMS -> engine decisions -> strong detector
on the offloaded images -> batched matching -> cascade mAP.

Integer outcomes (NMS keep counts, offload masks) must be equal and the mAP
equal within 1e-6.  A float difference that pushes a value across a
threshold (score 0.25, NMS IoU 0.45, the policy's T) fails with the stage
named in the message."""
import numpy as np
import pytest
import torch

from _torch_parity import seeded_detector_tree

import repro.api as japi
from repro.core import EstimatorConfig as JConfig
from repro.core.features import extract_features_batch as j_features
from repro.core.reward import cascade_map as j_cascade_map
from repro.core.reward import match_pairs_batched as j_match_pairs
from repro.data.shapes import ShapesDataset as JShapes
from repro.detection.batch import DetectionsBatch as JDB
from repro.models import detector as jdet
from repro_torch.api import OffloadEngine
from repro_torch.convert import detector_params_from_jax
from repro_torch.core.features import extract_features_batch
from repro_torch.core.reward import cascade_map, match_pairs_batched
from repro_torch.data.shapes import ShapesDataset
from repro_torch.detection.batch import DetectionsBatch as TDB
from repro_torch.models import detector as tdet

NUM_CLASSES, TOP_K, SIZE = 8, 25, 64.0
# the detectors are seeded, not trained: their boxes rarely reach IoU 0.5
# with the ground truth, so the lower threshold gives true positives to compare
T2 = (0.3, 0.5)


def _counts(dets):
    return np.array([len(d) for d in dets])


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    trees = {"weak": seeded_detector_tree(jdet.WEAK, 0, class_scale=10.0),
             "strong": seeded_detector_tree(jdet.STRONG, 1)}
    port = {}
    for name, cfg in (("weak", tdet.WEAK), ("strong", tdet.STRONG)):
        port[name] = tdet.Detector(cfg, device="cpu")
        port[name].load_state_dict(detector_params_from_jax(trees[name]))

    # the engine: fitted by repro on its own weak detections of a calibration set
    cal = JShapes.generate(64, seed=6)
    cal_dets = jdet.decode_detections(trees["weak"], jdet.WEAK, cal.images)
    jeng = japi.OffloadEngine(
        feature_extractor=japi.DetectionBoxFeatures(NUM_CLASSES, TOP_K, image_size=SIZE),
        reward_model=japi.MLPRewardModel(config=JConfig(hidden=(128,), epochs=3, batch_size=32)),
        ratio=0.3,
    )
    jeng.fit(JDB.from_list(cal_dets), np.random.default_rng(6).uniform(0, 1, 64))
    path = str(tmp_path_factory.mktemp("slice") / "engine.npz")
    jeng.save(path)
    return trees, port, jeng, OffloadEngine.load(path, device="cpu")


def test_datasets_are_identical():
    a, b = JShapes.generate(8, seed=5), ShapesDataset.generate(8, seed=5)
    np.testing.assert_array_equal(a.images, b.images)
    for ga, gb in zip(a.gts, b.gts):
        np.testing.assert_array_equal(ga.boxes, gb.boxes)
        np.testing.assert_array_equal(ga.classes, gb.classes)


def test_serve_path_matches_repro(slice_run):
    trees, port, jeng, teng = slice_run
    jds, tds = JShapes.generate(32, seed=5), ShapesDataset.generate(32, seed=5)

    # 1. weak detector + NMS
    jweak = jdet.decode_detections(trees["weak"], jdet.WEAK, jds.images)
    tweak = tdet.decode_detections(port["weak"], tds.images)
    np.testing.assert_array_equal(
        _counts(tweak), _counts(jweak),
        err_msg="stage: weak detector + NMS (score 0.25 / NMS IoU 0.45) keep counts",
    )
    assert _counts(jweak).sum() > 0

    # 2. engine decisions on the padded weak detections
    jdec = jeng.decide(JDB.from_list(jweak))
    tdec = teng.decide(TDB.from_list(tweak, device="cpu"))
    np.testing.assert_array_equal(
        tdec.offload, jdec.offload, err_msg="stage: engine decisions (policy threshold T)"
    )
    np.testing.assert_allclose(tdec.estimates, jdec.estimates, atol=2e-6, rtol=0)
    off = jdec.offload
    assert 0 < off.sum() < len(off)

    # 3. strong detector on the offloaded images only
    jstrong_off = jdet.decode_detections(trees["strong"], jdet.STRONG, jds.images[off])
    tstrong_off = tdet.decode_detections(port["strong"], tds.images[off])
    np.testing.assert_array_equal(
        _counts(tstrong_off), _counts(jstrong_off),
        err_msg="stage: strong detector + NMS on offloaded images",
    )

    # 4. batched matching and cascade mAP (strong results only where offloaded)
    def served(weak, strong_off):
        it = iter(strong_off)
        return [next(it) if o else w for w, o in zip(weak, off)]

    jimgs = j_match_pairs(jweak, served(jweak, jstrong_off), jds.gts, T2)
    timgs = match_pairs_batched(tweak, served(tweak, tstrong_off), tds.gts, T2, device="cpu")
    for o in (np.zeros_like(off), off):
        want = j_cascade_map(jimgs, o, T2)
        got = cascade_map(timgs, o, T2)
        assert got == pytest.approx(want, abs=1e-6), "stage: matching / cascade mAP"
    assert j_cascade_map(jimgs, off, T2) > 0


def test_on_card_batch_route_matches_from_list(slice_run):
    """The batch that keeps all 64 grid slots with the NMS keep mask as
    ``mask`` (what the card serves) gives the same features and decisions
    as padding the compacted per-image detections with ``from_list``, and
    the same features as repro's ``from_list`` route."""
    trees, port, jeng, teng = slice_run
    images = ShapesDataset.generate(24, seed=8).images
    masked = tdet.decode_batch(port["weak"], images)
    listed = tdet.decode_detections(port["weak"], images)
    np.testing.assert_array_equal(masked.counts.numpy(), _counts(listed))
    padded = TDB.from_list(listed, device="cpu")
    f_masked = extract_features_batch(masked, NUM_CLASSES, TOP_K, SIZE)
    f_listed = extract_features_batch(padded, NUM_CLASSES, TOP_K, SIZE)
    torch.testing.assert_close(f_masked, f_listed, rtol=0, atol=0)
    a, b = teng.decide(masked), teng.decide(padded)
    np.testing.assert_array_equal(a.offload, b.offload)
    np.testing.assert_array_equal(a.estimates, b.estimates)

    jlisted = jdet.decode_detections(trees["weak"], jdet.WEAK, images)
    np.testing.assert_allclose(
        f_masked.numpy(), j_features(JDB.from_list(jlisted), NUM_CLASSES, TOP_K, SIZE),
        atol=1e-6, rtol=0,
    )
    np.testing.assert_array_equal(a.offload, jeng.decide(JDB.from_list(jlisted)).offload)
