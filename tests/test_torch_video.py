"""The port's video layer (``repro_torch.video``) against ``repro.video`` on
the CPU, case by case after ``tests/test_video.py``.

The same seeds go to both packages.  Tolerances:

* clips, detections, frames and renders: exact (copied numpy);
* the tracker: the nine association fields (``ids``, ``active``,
  ``classes``, ``age``, ``det_track`` and the four counts) exact, boxes /
  vel / conf within 1e-5 (``tests/test_video.py``'s own), against
  ``repro``'s ``track_clip`` and both packages' ``track_clip_ref``;
* ``propagate``, ``fuse_detections``, the temporal features, the policies'
  decisions and ``frame_accuracies``: exact;
* serving: ``repro`` fits and saves the engine, the port loads the artifact
  (``OffloadEngine.load(device="cpu")``); records are equal field for
  field, estimates within 1e-5 (the MLP tolerance of
  ``tests/test_kernels.py``), and ``summary()`` is equal;
* the port's own scenario fit, from ``repro``'s initial weights
  (``repro_init``): the fitted weights within the AdamW criterion of
  ``tests/test_torch_train.py`` (every element within 2 lr_sum, at most 1%
  beyond 1e-5).
"""
import numpy as np
import pytest

import repro.detection.batch  # noqa: F401  (first: repro's kernels import it back)
import repro.video as jv
from repro.api import OffloadEngine as JOffloadEngine
from repro.api import make_policy as j_make_policy
from repro.detection.map_engine import Detections as JDetections
from repro.video.runtime import fuse_detections as j_fuse
from repro.video.track import propagate_rematch_ref as j_rematch

import repro_torch.video as tv
from repro_torch.api import MLPRewardModel, OffloadEngine, list_policies, make_policy
from repro_torch.api.policies import policy_context_params
from repro_torch.core import EstimatorConfig
from repro_torch.detection.map_engine import Detections
from repro_torch.obs import Obs
from repro_torch.runtime import OffloadSession
from repro_torch.video import (
    DetectionClip,
    SceneConfig,
    TrackerConfig,
    VideoRuntime,
    VideoTracker,
    default_video_scenario,
    frame_accuracies,
    generate_clip,
    run_video_scenario,
    synthesize_detections,
    track_clip,
    track_clip_ref,
)
from repro_torch.video.runtime import fuse_detections
from repro_torch.video.track import propagate_rematch_ref

from _torch_parity import repro_init  # noqa: F401  (fixture)

EXACT_FIELDS = (
    "ids", "active", "classes", "age", "det_track",
    "n_active", "n_matched", "n_new", "n_dead",
)
CLOSE_FIELDS = ("boxes", "vel", "conf")
TRACK_TOL = 1e-5  # tests/test_video.py's
EST_TOL = 1e-5  # tests/test_kernels.py's MLP tolerance
CLIP_FIELDS = ("boxes", "classes", "ids", "mask", "cuts")
DET_FIELDS = ("boxes", "scores", "classes", "mask")


def assert_tracks_equal(got, ref):
    for f in EXACT_FIELDS:
        g, r = getattr(got, f), getattr(ref, f)
        assert g.dtype == r.dtype and np.array_equal(g, r), f
    for f in CLOSE_FIELDS:
        np.testing.assert_allclose(
            getattr(got, f), getattr(ref, f), atol=TRACK_TOL, rtol=TRACK_TOL, err_msg=f
        )


def same_arrays(got, want, fields):
    for f in fields:
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and np.array_equal(g, w), f


def same_dets(got, want):
    np.testing.assert_array_equal(got.boxes, want.boxes)
    np.testing.assert_array_equal(got.scores, want.scores)
    np.testing.assert_array_equal(got.classes, want.classes)


def clip_pair(B, T, seed, **scene):
    return (jv.generate_clip(B, T, seed=seed, config=jv.SceneConfig(**scene)),
            generate_clip(B, T, seed=seed, config=SceneConfig(**scene)))


def weak_pair(B, T, seed, **scene):
    jclip, tclip = clip_pair(B, T, seed, **scene)
    return (jv.synthesize_detections(jclip, jv.WEAK_PROFILE, seed=seed + 1),
            synthesize_detections(tclip, tv.WEAK_PROFILE, seed=seed + 1))


def same_trace(got, want):
    """Two ``VideoFleetTrace``s: records equal but the estimates (1e-5),
    summaries equal."""
    assert got.n_streams == want.n_streams and got.n_frames == want.n_frames
    for gs, ws in zip(got.streams, want.streams):
        for g, w in zip(gs.records, ws.records, strict=True):
            g, w = g.as_dict(), w.as_dict()
            assert g.pop("estimate") == pytest.approx(w.pop("estimate"), abs=EST_TOL)
            assert g == w
        gt, wt = gs.telemetry.as_dict(include_video=True), ws.telemetry.as_dict(include_video=True)
        assert gt.pop("mean_estimate") == pytest.approx(wt.pop("mean_estimate"), abs=EST_TOL)
        assert gt == wt
    assert got.summary() == want.summary()


# ------------------------------------------------------------------ scene


@pytest.mark.parametrize("B,T,seed,scene", [
    (3, 24, 7, {}), (2, 40, 0, dict(p_cut=0.2, p_enter=0.3)),
    (4, 16, 5, dict(min_objects=1, max_objects=12, speed=4.0)),
])
def test_generate_clip_equals_repro(B, T, seed, scene):
    jclip, tclip = clip_pair(B, T, seed, **scene)
    same_arrays(tclip, jclip, CLIP_FIELDS)
    assert tclip.size == jclip.size
    again = generate_clip(B, T, seed=seed, config=SceneConfig(**scene))
    same_arrays(again, tclip, CLIP_FIELDS)


@pytest.mark.parametrize("profile", ["WEAK_PROFILE", "STRONG_PROFILE"])
def test_synthesize_detections_equals_repro(profile):
    jclip, tclip = clip_pair(3, 20, 3, p_cut=0.1)
    jd = jv.synthesize_detections(jclip, getattr(jv, profile), seed=4)
    td = synthesize_detections(tclip, getattr(tv, profile), seed=4)
    same_arrays(td, jd, DET_FIELDS)


def test_hard_class_profiles_equal_repro():
    """The class-conditional profiles of the shift scenario: same draws."""
    from repro.online.experiment import POST_SHIFT_PROFILE as JP
    from repro_torch.online.experiment import POST_SHIFT_PROFILE as TP

    jclip, tclip = clip_pair(2, 12, 9)
    same_arrays(synthesize_detections(tclip, TP, seed=3),
                jv.synthesize_detections(jclip, JP, seed=3), DET_FIELDS)


def test_render_frame_equals_repro():
    jclip, tclip = clip_pair(2, 6, 1)
    for t, b in ((0, 0), (3, 1), (5, 0)):
        np.testing.assert_array_equal(tv.render_frame(tclip, t, b, seed=2),
                                      jv.render_frame(jclip, t, b, seed=2))


def test_clip_containers_equal_repro():
    jclip, tclip = clip_pair(2, 8, 1)
    jw = jv.synthesize_detections(jclip, jv.WEAK_PROFILE, seed=2)
    tw = synthesize_detections(tclip, tv.WEAK_PROFILE, seed=2)
    fb, jfb = tw.frame(5, device="cpu"), jw.frame(5)
    for f in DET_FIELDS:
        np.testing.assert_array_equal(getattr(fb, f).numpy(), getattr(jfb, f))
    flat, jflat = tw.flatten(device="cpu"), jw.flatten()
    assert len(flat) == 16
    for f in DET_FIELDS:
        np.testing.assert_array_equal(getattr(flat, f).numpy(), getattr(jflat, f))
    gb = tclip.gt_frame(3, device="cpu")
    np.testing.assert_array_equal(gb.boxes.numpy(), jclip.gt_frame(3).boxes)
    same_dets(tw.det(5, 1), jw.det(5, 1))
    g, jg = tclip.gt(3, 1), jclip.gt(3, 1)
    np.testing.assert_array_equal(g.boxes, jg.boxes)
    np.testing.assert_array_equal(g.classes, jg.classes)
    assert len(tclip.gt_stream(0)) == 8


def test_detection_clip_from_frames_equals_repro():
    rng = np.random.default_rng(3)
    frames = []
    for _ in range(3):
        row = []
        for n in (0, 2, 11):
            xy = rng.uniform(0, 50, (n, 2))
            row.append((np.concatenate([xy, xy + 8], 1), rng.uniform(0, 1, n),
                        rng.integers(0, 8, n)))
        frames.append(row)
    got = DetectionClip.from_frames([[Detections(*a) for a in fr] for fr in frames])
    want = jv.DetectionClip.from_frames([[JDetections(*a) for a in fr] for fr in frames])
    same_arrays(got, want, DET_FIELDS)
    assert got.max_boxes == 16


# ---------------------------------------------------------------- tracker


@pytest.mark.parametrize("B,T,seed,p_cut", [(3, 20, 11, 0.1), (8, 48, 5, 0.05)])
def test_track_clip_equals_repro_on_real_clip(B, T, seed, p_cut):
    jw, tw = weak_pair(B, T, seed, p_cut=p_cut)
    cfg, jcfg = TrackerConfig(), jv.TrackerConfig()
    got = track_clip(tw, cfg, device="cpu")
    assert_tracks_equal(got, jv.track_clip(jw, jcfg))
    assert_tracks_equal(got, jv.track_clip_ref(jw, jcfg))
    assert_tracks_equal(track_clip_ref(tw, cfg), jv.track_clip_ref(jw, jcfg))
    assert got.n_matched.sum() > 0 and got.n_new.sum() > 0 and got.n_dead.sum() > 0


def test_streaming_update_equals_track_clip_and_repro():
    """Each streaming step equals repro's streaming tracker's and the
    clip's frame (the streaming tracker pads the K detection slots to
    ``max_dets``: ``det_track`` is the clip's, then -1)."""
    jw, tw = weak_pair(2, 12, 13)
    hist = track_clip(tw, device="cpu")
    K = tw.max_boxes
    vt, jvt = VideoTracker(2, device="cpu"), jv.VideoTracker(2)
    for t in range(12):
        tf, jtf = vt.update(tw.frame(t, device="cpu")), jvt.update(jw.frame(t))
        assert_tracks_equal(tf, jtf)
        clip_frame = hist.frame(t)
        np.testing.assert_array_equal(tf.det_track[:, :K], clip_frame.det_track)
        assert (tf.det_track[:, K:] == -1).all()
        tf.det_track = clip_frame.det_track
        assert_tracks_equal(tf, clip_frame)
        np.testing.assert_array_equal(tf.churn(), jtf.churn())
    assert vt.frame_index == 12 and vt.snapshot is tf
    vt.reset()
    assert vt.snapshot is None and vt.frame_index == 0


@pytest.mark.parametrize("seed", range(8))
def test_tracker_seeded_sweep_equals_repro(seed):
    """Seeded random clips on the 4-px grid: arbitrary non-prefix padded
    rows, empty frames, score ties (8 levels), and few track slots so that
    spawns overflow the free slots; held against repro's jitted scan and
    both references."""
    T, B, K = 6, 3, 8
    shape = (T, B, K)
    rng = np.random.default_rng(seed)
    x, y = rng.integers(0, 11, shape), rng.integers(0, 11, shape)
    w, h = rng.integers(2, 7, shape), rng.integers(2, 7, shape)
    boxes = (np.stack([x, y, x + w, y + h], -1) * 4).astype(np.float32)
    mask = rng.random(shape) < 0.6
    mask[rng.integers(0, T), rng.integers(0, B)] = False  # an empty frame
    scores = rng.choice([0.05, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.9], shape).astype(np.float32)
    classes = rng.integers(0, 3, shape).astype(np.int32)
    arrays = dict(boxes=np.where(mask[..., None], boxes, 0.0), scores=np.where(mask, scores, 0.0),
                  classes=np.where(mask, classes, -1), mask=mask)
    tdets, jdets = DetectionClip(**arrays), jv.DetectionClip(**arrays)
    kw = dict(max_tracks=(4, 8)[seed % 2], max_dets=K)
    got = track_clip(tdets, TrackerConfig(**kw), device="cpu")
    assert_tracks_equal(got, jv.track_clip(jdets, jv.TrackerConfig(**kw)))
    assert_tracks_equal(got, track_clip_ref(tdets, TrackerConfig(**kw)))


def test_tracker_guards():
    clip = generate_clip(2, 4, seed=0)
    weak = synthesize_detections(clip, seed=0)
    with pytest.raises(ValueError):
        VideoTracker(3, device="cpu").update(weak.frame(0, device="cpu"))
    big = Detections(np.zeros((6, 4)), np.zeros(6), np.zeros(6, int))
    with pytest.raises(ValueError):
        VideoTracker(1, TrackerConfig(max_dets=4), device="cpu").update(
            DetectionClip.from_frames([[big]]).frame(0, device="cpu"))


def test_propagate_equals_repro():
    """Stale edge results propagated through both trackers after the same
    frames: boxes snapped to the same tracks, scores decayed alike."""
    jw, tw = weak_pair(1, 10, 21)
    jstrong = jv.synthesize_detections(jv.generate_clip(1, 10, seed=21), jv.STRONG_PROFILE, seed=5)
    tstrong = synthesize_detections(generate_clip(1, 10, seed=21), tv.STRONG_PROFILE, seed=5)
    vt, jvt = VideoTracker(1, device="cpu"), jv.VideoTracker(1)
    snapped = 0
    for t in range(10):
        vt.update(tw.frame(t, device="cpu"))
        jvt.update(jw.frame(t))
        for t0 in range(max(t - 3, 0), t + 1):
            got = vt.propagate(tstrong.det(t0, 0), t0, t)
            want = jvt.propagate(jstrong.det(t0, 0), t0, t)
            same_dets(got, want)
            snapped += int((got.boxes != tstrong.det(t0, 0).boxes).any())
    assert snapped
    with pytest.raises(ValueError):
        vt.propagate(tstrong.det(0, 0), 3, 1)
    weak_frames = [tw.det(t, 0) for t in range(1, 6)]
    same_dets(propagate_rematch_ref(tstrong.det(0, 0), weak_frames),
              j_rematch(jstrong.det(0, 0), [jw.det(t, 0) for t in range(1, 6)]))


def test_propagate_snaps_to_tracks_and_decays():
    box = np.array([[8.0, 8.0, 24.0, 24.0]])
    dets = DetectionClip.from_frames([[Detections(box, [0.9], [2])] for _ in range(4)])
    vt = VideoTracker(1, TrackerConfig(stale_decay=0.5), device="cpu")
    for t in range(4):
        vt.update(dets.frame(t, device="cpu"))
    out = vt.propagate(Detections(box + 1.0, [0.8], [5]), 1, 3, stream=0)
    np.testing.assert_allclose(out.boxes, box)
    assert out.classes.tolist() == [5]
    assert out.scores[0] == pytest.approx(0.8 * 0.5 ** 2)


# --------------------------------------------------------------- features


def test_temporal_features_equal_repro():
    from repro.video import features as jf
    from repro_torch.video import features as tf

    jw, tw = weak_pair(2, 12, 17)
    for b in range(2):
        prev = jprev = None
        for t in range(12):
            cur, jcur = tw.det(t, b), jw.det(t, b)
            assert tf.frame_difference(prev, cur) == jf.frame_difference(jprev, jcur)
            if prev is not None:
                assert tf.detection_overlap(prev, cur, 0.3) == jf.detection_overlap(jprev, jcur, 0.3)
            prev, jprev = cur, jcur
    for ov, ch, w in ((0.2, 0.5, 0.6), (1.0, 0.0, 1.3), (0.0, 1.0, -0.1)):
        assert tf.scene_change_score(ov, ch, overlap_weight=w) == jf.scene_change_score(
            ov, ch, overlap_weight=w)
    s, js = tf.EwmaSmoother(0.3), jf.EwmaSmoother(0.3)
    for x in np.random.default_rng(0).uniform(0, 1, 20):
        assert s.update(x) == js.update(x)
    s.reset()
    assert s.value is None


def test_fuse_detections_equals_repro():
    jw, tw = weak_pair(1, 6, 31)
    js = jv.synthesize_detections(jv.generate_clip(1, 6, seed=31), jv.STRONG_PROFILE, seed=2)
    ts = synthesize_detections(generate_clip(1, 6, seed=31), tv.STRONG_PROFILE, seed=2)
    for t in range(6):
        same_dets(fuse_detections(ts.det(t, 0), tw.det(t, 0), 0.4),
                  j_fuse(js.det(t, 0), jw.det(t, 0), 0.4))
    empty = Detections(np.zeros((0, 4)), np.zeros(0), np.zeros(0, int))
    weak0, edge0 = tw.det(0, 0), ts.det(0, 0)
    assert fuse_detections(empty, weak0) is weak0
    assert fuse_detections(edge0, empty) is edge0


def test_frame_accuracies_equal_repro():
    jclip, tclip = clip_pair(3, 10, 41, p_cut=0.2)
    jw = jv.synthesize_detections(jclip, jv.WEAK_PROFILE, seed=4)
    tw = synthesize_detections(tclip, tv.WEAK_PROFILE, seed=4)
    order = [(t, b) for t in range(10) for b in range(3)]
    for thresholds in ((0.5,), (0.5, 0.75)):
        got = frame_accuracies([tw.det(t, b) for t, b in order], [tclip.gt(t, b) for t, b in order],
                               thresholds, device="cpu")
        want = jv.frame_accuracies([jw.det(t, b) for t, b in order],
                                   [jclip.gt(t, b) for t, b in order], thresholds)
        np.testing.assert_array_equal(got, want)
    assert frame_accuracies([], [], device="cpu").shape == (0,)
    with pytest.raises(ValueError):
        frame_accuracies([tw.det(0, 0)], [], device="cpu")


# ---------------------------------------------------------------- policies


def test_video_policies_registered():
    names = list_policies()
    assert "temporal_hysteresis" in names and "keyframe" in names
    assert policy_context_params("temporal_hysteresis") == ("staleness",)
    assert policy_context_params("keyframe") == ("scene_change",)


@pytest.mark.parametrize("name,kw", [
    ("temporal_hysteresis", dict()),
    ("temporal_hysteresis", dict(hysteresis=0.1, stale_credit=0.7, ewma=0.5)),
    ("keyframe", dict()),
    ("keyframe", dict(refractory=3, change_boost=0.9)),
])
@pytest.mark.parametrize("ratio", [0.0, 0.3, 0.6, 1.0])
def test_video_policy_decisions_equal_repro(name, kw, ratio):
    """Both packages' policies over one estimate stream with the same probe
    sequence (staleness with inf gaps, scene scores with cuts)."""
    rng = np.random.default_rng(8)
    cal, est = rng.uniform(0, 1, 300), rng.uniform(0, 1, 500)
    probe = np.where(rng.random(500) < 0.3, np.inf, rng.integers(0, 9, 500)) \
        if name == "temporal_hysteresis" else np.where(rng.random(500) < 0.1, 1.0, 0.0)
    param = policy_context_params(name)[0]
    out = []
    for mk in (make_policy, j_make_policy):
        it = iter(probe)
        p = mk(name, cal, ratio, **{param: lambda: float(next(it))}, **kw)
        out.append(np.array([p.decide(float(e)) for e in est]))
        assert p.spec() == mk(name, cal, ratio, **kw).spec()
    np.testing.assert_array_equal(out[0], out[1])


def test_video_policy_validation():
    cal = np.zeros(8)
    for name, kw in (("temporal_hysteresis", dict(stale_horizon=0.0)),
                     ("temporal_hysteresis", dict(ewma=0.0)), ("keyframe", dict(refractory=0))):
        with pytest.raises(ValueError):
            make_policy(name, cal, 0.3, **kw)


def test_video_policy_save_strips_probes(tmp_path):
    """The port saves a temporal_hysteresis engine without its probe; repro
    loads it (and the port reloads it) with the kwargs kept."""
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (128, 8)).astype(np.float32)
    eng = OffloadEngine(
        reward_model=MLPRewardModel(config=EstimatorConfig(hidden=(8,), epochs=2), device="cpu"),
        policy="temporal_hysteresis",
        policy_kwargs=dict(staleness=lambda: 1.0, stale_credit=0.7),
        ratio=0.3,
        device="cpu",
    )
    eng.fit(features=x, rewards=rng.normal(0, 1, 128))
    path = str(tmp_path / "video_engine")
    eng.save(path)
    for loaded in (OffloadEngine.load(path, device="cpu"), JOffloadEngine.load(path)):
        assert loaded.policy_name == "temporal_hysteresis"
        assert "staleness" not in loaded.policy_kwargs
        assert loaded.policy_kwargs["stale_credit"] == 0.7
        assert loaded.policy.staleness is None


# ------------------------------------------------------------- end to end


@pytest.fixture(scope="module")
def scenarios(tmp_path_factory):
    """repro's default scenario and the port's, the port serving repro's
    fitted engine (an artifact on disk); the port's own fitted engine is
    kept aside."""
    jscn = jv.default_video_scenario(8, 96, seed=0)
    path = str(tmp_path_factory.mktemp("video") / "engine")
    jscn.engine.save(path)
    tscn = default_video_scenario(8, 96, seed=0, device="cpu")
    own = tscn.engine
    tscn.engine = OffloadEngine.load(path, device="cpu")
    return jscn, tscn, own


def test_scenario_clips_equal_repro(scenarios):
    jscn, tscn, own = scenarios
    same_arrays(tscn.clip, jscn.clip, CLIP_FIELDS)
    same_arrays(tscn.weak, jscn.weak, DET_FIELDS)
    same_arrays(tscn.strong, jscn.strong, DET_FIELDS)
    assert own.device.type == "cpu" and own.feature_extractor.feature_dim == 132


def test_serve_clip_small_equals_repro(scenarios):
    """3 streams x 32 frames on repro's fitted engine, with and without
    fusion: records, telemetry and summary equal repro's; the ``video.*``
    profiler spans are recorded."""
    jscn, tscn, _ = scenarios
    jclip, tclip = clip_pair(3, 32, 77, p_cut=0.05)
    jweak = jv.synthesize_detections(jclip, jv.WEAK_PROFILE, seed=78)
    tweak = synthesize_detections(tclip, tv.WEAK_PROFILE, seed=78)
    jstrong = jv.synthesize_detections(jclip, jv.STRONG_PROFILE, seed=79)
    tstrong = synthesize_detections(tclip, tv.STRONG_PROFILE, seed=79)
    for fuse in (True, False):
        obs = Obs()
        got = VideoRuntime(tscn.engine, tscn.fleet(), seed=0, obs=obs).serve_clip(
            tweak, tstrong, tclip, ratio=0.4, fuse=fuse)
        want = jv.VideoRuntime(jscn.engine, jscn.fleet(), seed=0).serve_clip(
            jweak, jstrong, jclip, ratio=0.4, fuse=fuse)
        same_trace(got, want)
        spans = obs.profiler.report()
        assert spans["video.track"]["count"] == 32 and spans["video.serve_frames"]["count"] == 32
        assert spans["video.score_accuracy"]["count"] == 1
    with pytest.raises(ValueError):
        VideoRuntime(tscn.engine, tscn.fleet()).serve_clip(tweak, tstrong, generate_clip(2, 32))


@pytest.mark.parametrize("policy", ["temporal_hysteresis", "keyframe"])
def test_video_scenario_equals_repro(scenarios, policy):
    jscn, tscn, _ = scenarios
    same_trace(run_video_scenario(tscn, policy, ratio=0.3),
               jv.run_video_scenario(jscn, policy, ratio=0.3))


def test_serve_clip_staleness_and_accuracy_semantics(scenarios):
    _, scenario, _ = scenarios
    trace = run_video_scenario(scenario, "temporal_hysteresis", ratio=0.3)
    assert trace.n_streams == 8 and trace.n_frames == 96
    covered = 0
    for s in trace.streams:
        for r in s.records:
            assert r.effective_accuracy is not None and 0.0 <= r.effective_accuracy <= 1.0
            assert (r.staleness is not None) == (r.source == "edge")
            if r.source == "edge":
                covered += 1
                assert 0.0 <= r.staleness <= scenario.max_stale
            else:
                assert r.source == "weak"
        tel = s.telemetry
        assert tel.effective_frames == len(s.records)
        assert tel.covered_frames == sum(r.source == "edge" for r in s.records)
        d = tel.as_dict(include_video=True)
        assert d["mean_effective_accuracy"] == pytest.approx(s.effective_accuracy())
    assert covered
    first_edge = min(r.step for s in trace.streams for r in s.records if r.source == "edge")
    assert first_edge > 0
    assert trace.summary()["staleness"]["covered_fraction"] > 0.2


def test_video_trace_bit_identical_across_runs(scenarios):
    _, scenario, _ = scenarios
    t1 = run_video_scenario(scenario, "keyframe", ratio=0.3)
    t2 = run_video_scenario(scenario, "keyframe", ratio=0.3)
    for s1, s2 in zip(t1.streams, t2.streams):
        assert s1.records == s2.records
    assert t1.summary() == t2.summary()


def test_temporal_hysteresis_beats_threshold_at_equal_ratio(scenarios):
    """tests/test_video.py's headline, in the port on repro's engine."""
    _, scenario, _ = scenarios
    qa = run_video_scenario(scenario, "temporal_hysteresis", ratio=0.3)
    r_qa, acc_qa = qa.realized_ratio(), qa.mean_effective_accuracy()
    runs = [run_video_scenario(scenario, "threshold", ratio=t)
            for t in (0.21, 0.24, 0.27, 0.30, 0.33)]
    th = min(runs, key=lambda tr: abs(tr.realized_ratio() - r_qa))
    assert abs(th.realized_ratio() - r_qa) < 0.03, (th.realized_ratio(), r_qa)
    assert acc_qa > th.mean_effective_accuracy(), (acc_qa, th.mean_effective_accuracy())
    for tr in runs:
        if tr.realized_ratio() <= r_qa + 0.02:
            assert acc_qa > tr.mean_effective_accuracy()
    assert (qa.staleness_profile()["covered_fraction"]
            >= th.staleness_profile()["covered_fraction"])


def test_session_injects_temporal_probes(scenarios):
    _, scenario, _ = scenarios
    eng = scenario.engine.with_policy("temporal_hysteresis", ratio=0.3)
    s = OffloadSession(eng, micro_batch=1, staleness=lambda: 0.0, scene_change=lambda: 1.0)
    assert s.policy.staleness is not None and not hasattr(s.policy, "scene_change")


def test_default_video_scenario_fit_from_repro_init(repro_init):
    """The port's own scenario fit (15 epochs, 45 AdamW steps on 192 rows)
    from repro's initial weights: within 2 lr_sum of repro's fitted
    weights, at most 1% of elements beyond 1e-5; equal calibration
    rewards (exact: the matching is)."""
    from repro_torch.train.schedule import warmup_cosine

    jscn = jv.default_video_scenario(2, 8, seed=3)
    tscn = default_video_scenario(2, 8, seed=3, device="cpu")
    jp = jscn.engine.reward_model.estimator.params
    tp = tscn.engine.reward_model.estimator.params
    cfg = tscn.engine.reward_model.config
    total = cfg.epochs * max(192 // cfg.batch_size, 1)
    sched = warmup_cosine(cfg.lr, max(total // 20, 1), total)
    lr_sum = sum(sched(i) for i in range(total))
    far = size = 0
    for layer in jp:
        for k in jp[layer]:
            g, w = tp[layer][k].numpy(), np.asarray(jp[layer][k])
            np.testing.assert_allclose(g, w, atol=2 * lr_sum, rtol=0, err_msg=f"{layer}.{k}")
            far += int((np.abs(g - w) > 1e-5).sum())
            size += w.size
    assert far / size <= 0.01, (far, size)
    np.testing.assert_array_equal(tscn.engine.transform.state()["sorted_rewards"],
                                  jscn.engine.transform.state()["sorted_rewards"])
