"""An ``OffloadEngine`` fitted and saved by ``repro`` loads in the port and
decides identically on the CPU; an artifact the port saves loads in
``repro``.  Estimates are compared at equal batch shapes (2e-6), offload
masks exactly."""
import numpy as np
import pytest
import torch

from _torch_parity import both_detections, random_detection_arrays

import repro.api as japi
from repro.core import EstimatorConfig as JConfig
from repro.detection.batch import DetectionsBatch as JDB
from repro_torch.api import OffloadEngine
from repro_torch.detection.batch import DetectionsBatch as TDB

NUM_CLASSES, TOP_K, SIZE = 8, 25, 64.0


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    rng = np.random.default_rng(0)
    cal, _ = both_detections(random_detection_arrays(rng, 200, 40, NUM_CLASSES, scale=SIZE))
    eng = japi.OffloadEngine(
        feature_extractor=japi.DetectionBoxFeatures(NUM_CLASSES, TOP_K, image_size=SIZE),
        reward_model=japi.MLPRewardModel(
            config=JConfig(hidden=(128,), epochs=3, batch_size=64)
        ),
        ratio=0.3,
    )
    eng.fit(JDB.from_list(cal), rng.uniform(0, 1, 200))
    assert eng.reward_model.fused
    path = str(tmp_path_factory.mktemp("engine") / "engine.npz")
    eng.save(path)
    return eng, path


def _request(seed, n=48, kmax=40):
    arrays = random_detection_arrays(np.random.default_rng(seed), n, kmax, NUM_CLASSES, scale=SIZE)
    jd, td = both_detections(arrays)
    return JDB.from_list(jd), TDB.from_list(td, device="cpu"), td


def _same_decisions(got, want):
    np.testing.assert_array_equal(got.offload, want.offload)
    np.testing.assert_allclose(got.estimates, want.estimates, atol=2e-6, rtol=0)
    assert got.estimates.dtype == np.float32


@pytest.mark.parametrize("seed", [1, 2])
def test_repro_artifact_decides_identically(artifact, seed):
    jeng, path = artifact
    teng = OffloadEngine.load(path, device="cpu")
    jb, tb, tdets = _request(seed)
    want = jeng.decide(jb)
    _same_decisions(teng.decide(tb), want)  # fused score_pipeline route
    _same_decisions(teng.decide(tdets), want)  # ragged list: features + MLP
    assert 0 < want.offload.sum() < len(want.offload)


def test_features_route_takes_estimator_mlp(artifact):
    from repro.core.features import extract_features_batch

    jeng, path = artifact
    teng = OffloadEngine.load(path, device="cpu")
    jb, _, _ = _request(3)
    x = extract_features_batch(jb, NUM_CLASSES, TOP_K, SIZE)
    _same_decisions(teng.decide(features=x), jeng.decide(features=x))
    np.testing.assert_allclose(teng.score(features=x), jeng.score(features=x), atol=2e-6)


def test_port_artifact_loads_in_repro(artifact, tmp_path):
    jeng, path = artifact
    teng = OffloadEngine.load(path, device="cpu")
    out = str(tmp_path / "from_port.npz")
    teng.save(out)
    back = japi.OffloadEngine.load(out)
    jb, _, _ = _request(4)
    want = jeng.decide(jb)
    got = back.decide(jb)
    np.testing.assert_array_equal(got.offload, want.offload)
    np.testing.assert_array_equal(got.estimates, want.estimates)
    np.testing.assert_array_equal(back.calibration_scores, jeng.calibration_scores)


@pytest.mark.parametrize(
    "change",
    [("ratio", 0.55), ("policy", "topk", 0.4), ("policy", "token_bucket", 0.25),
     ("policy", "threshold", 0.0)],
)
def test_set_ratio_and_with_policy_follow(artifact, change):
    jeng, path = artifact
    teng = OffloadEngine.load(path, device="cpu")
    jeng = japi.OffloadEngine.load(path)
    if change[0] == "ratio":
        jeng.set_ratio(change[1])
        teng.set_ratio(change[1])
    else:
        jeng = jeng.with_policy(change[1], ratio=change[2])
        teng = teng.with_policy(change[1], ratio=change[2])
    jb, tb, _ = _request(5)
    _same_decisions(teng.decide(tb), jeng.decide(jb))
    assert teng.policy.ratio == jeng.policy.ratio


def test_empty_request(artifact):
    _, path = artifact
    teng = OffloadEngine.load(path, device="cpu")
    dec = teng.decide(TDB.from_list([], device="cpu"))
    assert dec.estimates.shape == (0,) and dec.offload.shape == (0,)


def test_pipeline_params_cached_by_identity(artifact):
    _, path = artifact
    model = OffloadEngine.load(path, device="cpu").reward_model
    first = model.pipeline_params()
    assert model.pipeline_params() is first
    est = model.estimator
    est.params = {"layer0": est.params["layer0"],
                  "layer1": {k: v + 0.25 for k, v in est.params["layer1"].items()}}
    fresh = model.pipeline_params()
    assert fresh is not first
    torch.testing.assert_close(fresh["w2"], first["w2"] + 0.25)


def test_detection_feature_dim_matches_repro(artifact):
    jeng, path = artifact
    teng = OffloadEngine.load(path, device="cpu")
    assert teng.feature_extractor.feature_dim == jeng.feature_extractor.feature_dim
    jb, tb, _ = _request(6)
    assert teng.features(tb).shape[1] == teng.feature_extractor.feature_dim


def test_detection_session_routes_match_repro(artifact):
    """A stream of detection requests through ``OffloadSession``: the fast
    path (a whole ``DetectionsBatch``, ``score_pipeline``), the buffered
    path (``flush=False``: features, then ``estimator_mlp`` a micro-batch)
    and single frames (a ``Detections`` as in repro, or a one-row
    ``DetectionsBatch`` as the card's detector leaves it) decide as repro's
    sessions.  Fast against buffered: estimates within 1e-5, decisions equal
    except rows within 1e-5 of the threshold (counted, not hidden)."""
    from repro.runtime import OffloadSession as JSession

    from repro_torch.runtime import OffloadSession

    jeng, path = artifact
    teng = OffloadEngine.load(path, device="cpu")
    jb, tb, tdets = _request(7, n=40)
    jdets = jb.to_list()

    def same(got, want, atol=2e-6):
        assert [d.step for d in got] == [d.step for d in want]
        assert [d.offload for d in got] == [d.offload for d in want]
        np.testing.assert_allclose([d.estimate for d in got], [d.estimate for d in want],
                                   atol=atol, rtol=0)

    fast = OffloadSession(teng, micro_batch=8).submit_batch(tb)
    same(fast, JSession(jeng, micro_batch=8).submit_batch(jb))
    buffered = OffloadSession(teng, micro_batch=8)
    jbuffered = JSession(jeng, micro_batch=8)
    slow = buffered.submit_batch(tb, flush=False) + buffered.flush()
    same(slow, jbuffered.submit_batch(jb, flush=False) + jbuffered.flush(), atol=1e-5)
    frames, one_row = OffloadSession(teng, micro_batch=8), OffloadSession(teng, micro_batch=8)
    jframes = JSession(jeng, micro_batch=8)
    got, rows, want = [], [], []
    for i in range(len(tdets)):
        got += frames.submit(tdets[i])
        rows += one_row.submit(TDB(**{f: getattr(tb, f)[i : i + 1]
                                      for f in ("boxes", "scores", "classes", "mask")}))
        want += jframes.submit(jdets[i])
    same(got, want, atol=1e-5)
    same(rows, got, atol=0)
    est_f = np.array([d.estimate for d in fast])
    est_b = np.array([d.estimate for d in slow])
    np.testing.assert_allclose(est_b, est_f, atol=1e-5, rtol=0)
    thr = teng.policy.threshold
    near = np.abs(est_f - thr) <= 1e-5
    flips = np.array([a.offload != b.offload for a, b in zip(fast, slow)])
    assert not (flips & ~near).any(), f"{int(flips.sum())} flips, {int(near.sum())} rows near"
    with pytest.raises(ValueError, match="one frame"):
        frames.submit(tb)
