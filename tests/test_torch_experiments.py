"""The port's paper experiments against the JAX package's, on the CPU:
``match_pairs`` / ``ori`` / ``ori_batch``, TIDE, the baselines (Adaptive
Feeding's SVM, DCSB, random), ``Cascade``, and every figure and table of
``experiments/detection_repro.py`` on the tiny pipeline.

Host numpy outputs (ORI, TIDE, Figs. 5/6/8, Table II, the oracle, random
and DCSB curves, the token-bucket study) are held exactly, from the same
``PipelineState`` inputs (``repro``'s state copied into the port's
classes).  Fits: the SVM's weights at 1e-5, its masks equal except rows
with |decision| < 1e-4; ``train_estimators`` at 1e-4 out of fold from
``repro``'s initial weights (float32 training, tests/test_torch_train.py);
estimates served through one ``repro``-fitted artifact at 1e-5."""
import json

import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401  (pipelines, repro_*init: shared fixtures)
    pipelines,
    port_state,
    repro_cnn_init,
    repro_init,
)

import repro.detection.batch  # noqa: F401  (first: repro's kernels import it back)
import repro.core as jcore
import repro.experiments.detection_repro as jdr
from repro.detection.map_engine import Detections as JDetections
from repro.detection.map_engine import GroundTruth as JGroundTruth
from repro.detection.tide import tide_errors as j_tide_errors

import repro_torch.core as tcore
import repro_torch.detection as tdet
import repro_torch.experiments.detection_repro as tdr
from repro_torch.api import OffloadEngine
from repro_torch.detection.batch import DetectionsBatch
from repro_torch.detection.map_engine import Detections, GroundTruth

EST_TOL = 1e-5  # tests/test_kernels.py's MLP tolerance
FIT_TOL = 1e-4  # float32 training from one init, tests/test_torch_train.py


def port_lists(gts, weak, strong):
    """``repro``'s detection / ground-truth lists as the port's."""
    def dets(ds):
        return [Detections(d.boxes.copy(), d.scores.copy(), d.classes.copy()) for d in ds]

    return [GroundTruth(g.boxes.copy(), g.classes.copy()) for g in gts], dets(weak), dets(strong)


def same_evals(got, want):
    assert got.gt_counts == want.gt_counts
    assert sorted(got.per_class) == sorted(want.per_class)
    for c in want.per_class:
        np.testing.assert_array_equal(got.per_class[c][0], want.per_class[c][0])
        np.testing.assert_array_equal(got.per_class[c][1], want.per_class[c][1])
        np.testing.assert_array_equal(got.matched_gt[c], want.matched_gt[c])


@pytest.fixture(scope="module")
def states(pipelines):
    """(repro's state, the same inputs in the port's classes)."""
    jstate = pipelines[0]
    return jstate, port_state(jstate)


# ------------------------------------------------------------ ORI, matching


def test_match_pairs_equals_repro(noisy_pair):
    gts, weak, strong = noisy_pair
    tgts, tweak, tstrong = port_lists(gts, weak, strong)
    want = jcore.match_pairs(weak, strong, gts)
    got = tcore.match_pairs(tweak, tstrong, tgts)
    batched = tcore.match_pairs_batched(tweak, tstrong, tgts, device="cpu")
    assert len(got) == len(want) == len(batched) == len(gts)
    for g, b, w in zip(got, batched, want):
        for part in ("weak", "strong"):
            same_evals(getattr(g, part), getattr(w, part))
            b_ev, g_ev = getattr(b, part), getattr(g, part)
            for c in g_ev.per_class:  # the batched plane's tp / match_gt, the same pairs
                np.testing.assert_array_equal(b_ev.per_class[c][1], g_ev.per_class[c][1])
                np.testing.assert_array_equal(b_ev.matched_gt[c], g_ev.matched_gt[c])


@pytest.mark.parametrize("thresholds", [(0.5,), (0.5, 0.75)])
def test_ori_and_ori_batch_equal_repro(noisy_pair, thresholds):
    gts, weak, strong = noisy_pair
    tgts, tweak, tstrong = port_lists(gts, weak, strong)
    jm = jcore.match_pairs(weak, strong, gts, thresholds)
    tm = tcore.match_pairs(tweak, tstrong, tgts, thresholds)
    want = jcore.ori_batch(jm, thresholds)
    got = tcore.ori_batch(tm, thresholds)
    np.testing.assert_array_equal(got, want)
    assert [tcore.ori(m, thresholds) for m in tm] == [jcore.ori(m, thresholds) for m in jm]
    assert (want != 0).any() and (want == 0).any()


def test_ori_on_the_pipeline_equals_repro(states):
    jstate, pstate = states
    np.testing.assert_array_equal(tcore.ori_batch(pstate.val_pairs),
                                  jcore.ori_batch(jstate.val_pairs))


# -------------------------------------------------------------------- TIDE


def test_tide_errors_equal_repro(noisy_pair):
    gts, weak, strong = noisy_pair
    tgts, tweak, tstrong = port_lists(gts, weak, strong)
    for tf, tb in ((0.5, 0.1), (0.75, 0.3)):
        want = j_tide_errors(weak, gts, tf=tf, tb=tb)
        assert tdet.tide_errors(tweak, tgts, tf=tf, tb=tb) == want
        assert tdet.tide_errors(tstrong, tgts, tf=tf, tb=tb) == j_tide_errors(strong, gts, tf=tf,
                                                                              tb=tb)
    assert sum(want[f"{c}_count"] for c in tdet.CATEGORIES) > 0


def test_tide_specific_errors_and_empty_images():
    gt = ([0.0, 0, 10, 10], [30.0, 30, 40, 40]), (0, 1)
    det = ([[0.0, 0, 10, 10], [50.0, 50, 60, 60], [1.0, 1, 11, 11], [0.0, 0, 10, 20]],
           [0.9, 0.8, 0.7, 0.6], [3, 2, 3, 0])
    cases = [(det, gt), (([], [], []), gt), ((det[0][:1], [0.5], [0]), ((), ()))]
    for (boxes, scores, classes), (gboxes, gclasses) in cases:
        jd = [JDetections(np.array(boxes), np.array(scores), np.array(classes))]
        jg = [JGroundTruth(np.array(gboxes), np.array(gclasses))]
        td = [Detections(np.array(boxes), np.array(scores), np.array(classes))]
        tg = [GroundTruth(np.array(gboxes), np.array(gclasses))]
        assert tdet.tide_errors(td, tg) == j_tide_errors(jd, jg)
    assert tdet.tide_errors([Detections(*map(np.array, det))],
                            [GroundTruth(*map(np.array, gt))])["cls_count"] == 2


# --------------------------------------------------------- figures, tables


@pytest.mark.parametrize("name,kwargs", [
    ("figure5_context_size", dict(context_sizes=(0, 8, 32, 64), n_draws=3)),
    ("table2_conservatism", dict(context_size=32)),
    ("figure6_error_types", dict(context_size=32, ratio=0.3)),
    ("figure8_reward_cdf", dict(context_size=32)),
])
def test_figures_equal_repro(states, name, kwargs):
    """The host numpy figures, from the same state and seed: equal to the
    last bit (NaN where a subset is empty, as in repro)."""
    jstate, pstate = states
    want = getattr(jdr, name)(jstate, **kwargs)
    got = getattr(tdr, name)(pstate, **kwargs)
    np.testing.assert_equal(got, want)


def test_figures_on_the_ports_own_state(pipelines):
    """On the port's own pipeline (detections within 1e-5 of repro's, the
    matches exact) the figures agree with repro's within 1e-4."""
    jstate, tstate, _, _ = pipelines
    want = jdr.figure5_context_size(jstate, context_sizes=(0, 32), n_draws=2)
    got = tdr.figure5_context_size(tstate, context_sizes=(0, 32), n_draws=2)
    for key, curve in want["curves"].items():
        np.testing.assert_allclose(got["curves"][key]["mean"], curve["mean"], atol=1e-4)
    assert tdr.figure8_reward_cdf(tstate, 32)["ori_quantiles"] == pytest.approx(
        jdr.figure8_reward_cdf(jstate, 32)["ori_quantiles"], abs=1e-4)


# --------------------------------------------------------------- baselines


def _features(seed, n=96, f=12, ties=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, f)).astype(np.float32)
    x[:ties] = x[0]  # identical rows (an image with no detections): margins tie
    difficult = rng.uniform(size=n) < 0.4
    return x, difficult


@pytest.mark.parametrize("c_plus,epochs", [(0.125, 60), (1.0, 60), (4.0, 30)])
def test_adaptive_feeding_svm_equals_repro(c_plus, epochs):
    x, difficult = _features(int(c_plus * 8))
    want = jcore.AdaptiveFeedingSVM(c_plus=c_plus, epochs=epochs).fit(x, difficult)
    got = tcore.AdaptiveFeedingSVM(c_plus=c_plus, epochs=epochs, device="cpu").fit(x, difficult)
    np.testing.assert_allclose(got.w, want.w, atol=1e-5)
    assert got.b == pytest.approx(want.b, abs=1e-5)
    np.testing.assert_array_equal(got._mu, want._mu)
    np.testing.assert_array_equal(got._sigma, want._sigma)
    dec = want.decision(x)
    far = np.abs(dec) >= 1e-4
    np.testing.assert_array_equal(got.predict(x)[far], want.predict(x)[far])
    assert 0 < want.predict(x).sum() < len(x)


def test_adaptive_feeding_hinge_tie_passes_half_the_gradient():
    """At margin exactly 1 the hinge's subgradient is half of the active
    side's, as jnp.maximum's: one row at the kink moves w by half."""
    zero = torch.zeros(())
    m = torch.tensor([1.0, 0.5, 2.0], requires_grad=True)
    torch.maximum(zero, 1.0 - m).sum().backward()
    np.testing.assert_array_equal(m.grad.numpy(), [-0.5, -1.0, 0.0])


def test_dcsb_and_random_equal_repro(noisy_pair):
    gts, weak, strong = noisy_pair
    _, tweak, tstrong = port_lists(gts, weak, strong)
    for floor in (0.1, 0.5):
        for g, w in zip(tcore.dcsb_signals(tweak, floor), jcore.dcsb_signals(weak, floor)):
            np.testing.assert_array_equal(g, w)
        got, want = tcore.fit_dcsb(tweak, tstrong, floor), jcore.fit_dcsb(weak, strong, floor)
        assert (got.thr_count, got.thr_area) == (want.thr_count, want.thr_area)
        counts, areas = tcore.dcsb_signals(tweak, floor)
        np.testing.assert_array_equal(got.predict_signals(counts, areas),
                                      want.predict_signals(counts, areas))
    for n, r in ((60, 0.2), (61, 0.5), (10, 1.0), (10, 0.0)):
        np.testing.assert_array_equal(
            tcore.random_offload_mask(n, r, np.random.default_rng(3)),
            jcore.random_offload_mask(n, r, np.random.default_rng(3)))


# ------------------------------------------------------ estimators, policies


@pytest.fixture(scope="module")
def bundles(states):
    """repro's out-of-fold bundle (2 epochs, its init) for the policy
    evaluations that take a bundle as input."""
    jstate, _ = states
    return jdr.train_estimators(jstate, context_size=32, epochs=2)


@pytest.mark.parametrize("epochs", [2, 4])
def test_train_estimators_equal_repro(states, repro_init, epochs):
    jstate, pstate = states
    want = jdr.train_estimators(jstate, context_size=32, epochs=epochs)
    got = tdr.train_estimators(pstate, context_size=32, epochs=epochs, device="cpu")
    assert list(got.preds) == list(want.preds)
    for k in ("ORIC", "ORI"):
        np.testing.assert_array_equal(got.rewards[k], want.rewards[k])
    for k, v in want.preds.items():
        # the two heads without a sigmoid are unbounded: out of fold, a row
        # standardized by a tiny training sigma reaches ~9e4 here, where a
        # float32 ulp is ~8e-3, so they are held at FIT_TOL relative too
        rtol = FIT_TOL if k in ("ORIC_vanilla", "ORI") else 0.0
        np.testing.assert_allclose(got.preds[k], v, atol=FIT_TOL, rtol=rtol, err_msg=k)


def _bundle(jbundle):
    return tdr.EstimatorBundle(preds={k: v.copy() for k, v in jbundle.preds.items()},
                               rewards={k: v.copy() for k, v in jbundle.rewards.items()})


def test_evaluate_policies_equal_repro(states, bundles):
    """From the same state and bundle: the oracle, estimated, random and DCSB
    entries equal repro's exactly; the SVM points wherever their masks do."""
    jstate, pstate = states
    want = jdr.evaluate_policies(jstate, bundles)
    got = tdr.evaluate_policies(pstate, _bundle(bundles), device="cpu")
    assert got["ratios"] == want["ratios"] and list(got["curves"]) == list(want["curves"])
    for name, curve in want["curves"].items():
        assert got["curves"][name] == curve, name
    assert got["dcsb"] == want["dcsb"]
    x, difficult = pstate.features_val, bundles.rewards["ORI"] > 0
    for g, w in zip(got["adaptive_feeding"], want["adaptive_feeding"]):
        assert g["c_plus"] == w["c_plus"]
        svm = jcore.AdaptiveFeedingSVM(c_plus=w["c_plus"], epochs=60).fit(x, difficult)
        if (np.abs(svm.decision(x)) >= 1e-4).all():
            assert g == w
    ratios = np.array(want["ratios"])
    oracle, rand = want["curves"]["oracle_ORIC"]["map"], want["curves"]["random"]["map"]
    assert all(o >= r for o, r, q in zip(oracle, rand, ratios) if q < 1)


def test_policy_ranking_matches_repro(states, pipelines, repro_init):
    """Each package trains its own estimators (from repro's init) and ranks
    the policies at every ratio: the same order as repro's."""
    jstate, pstate = states
    want = jdr.evaluate_policies(jstate, jdr.train_estimators(jstate, context_size=32, epochs=3))
    got = tdr.evaluate_policies(
        pstate, tdr.train_estimators(pstate, context_size=32, epochs=3, device="cpu"),
        device="cpu")
    names = list(want["curves"])
    for i, r in enumerate(want["ratios"]):
        def rank(res):
            maps = {n: round(res["curves"][n]["map"][i], 9) for n in names}
            return sorted(names, key=lambda n: (-maps[n], n))
        assert rank(got) == rank(want), r
    for name in names:  # every curve ends at the strong detector's mAP
        assert got["curves"][name]["map"][-1] == pytest.approx(pstate.strong_map, abs=1e-12)


def test_token_bucket_study_equals_repro(states, bundles):
    jstate, pstate = states
    for rate, depth in ((0.2, 8.0), (0.5, 2.0)):
        assert tdr.token_bucket_study(pstate, _bundle(bundles), rate=rate, depth=depth) == \
            jdr.token_bucket_study(jstate, bundles, rate=rate, depth=depth)


# ------------------------------------------------- engines, cascade, stream


@pytest.fixture(scope="module")
def served(states, tmp_path_factory):
    """repro's ``build_engine`` on its state, saved; the port serves the
    artifact on the CPU."""
    jstate, _ = states
    jeng = jdr.build_engine(jstate, context_size=32, epochs=3)
    path = str(tmp_path_factory.mktemp("engine") / "engine")
    jeng.save(path)
    return jeng, OffloadEngine.load(path, device="cpu")


def test_streaming_study_equals_repro(states, served):
    jstate, pstate = states
    jeng, teng = served
    want = jdr.streaming_multi_edge_study(jstate, jeng, micro_batch=8)
    got = tdr.streaming_multi_edge_study(pstate, teng, micro_batch=8, device="cpu")
    ws, gs = want.pop("summary"), got.pop("summary")
    assert got == want
    assert gs["outcomes"] == ws["outcomes"] and gs["dispatcher"] == ws["dispatcher"]


def test_cascade_from_engine_equals_engine_decide(states, served):
    """Item by item, as ``engine.decide`` on the whole batch, and as repro's
    cascade over the same artifact; a one-frame ``DetectionsBatch`` takes
    the fused ``score_pipeline`` route."""
    jstate, pstate = states
    jeng, teng = served
    strong = dict(enumerate(pstate.strong_dets_val))
    items = list(range(len(pstate.weak_dets_val)))
    batch = teng.decide(pstate.weak_dets_val)
    thr = teng.policy.threshold
    near = np.abs(batch.estimates - thr) <= EST_TOL
    for weak_fn in (lambda i: pstate.weak_dets_val[i],
                    lambda i: DetectionsBatch.from_list([pstate.weak_dets_val[i]], device="cpu")):
        cascade = tcore.Cascade.from_engine(weak_fn, strong.__getitem__, teng)
        records = cascade.run(items)
        est = np.array([r.estimate for r in records])
        off = np.array([r.offloaded for r in records])
        np.testing.assert_allclose(est, batch.estimates, atol=EST_TOL)
        np.testing.assert_array_equal(off[~near], batch.offload[~near])
        for r, i in zip(records, items):
            assert (r.final_output is strong[i]) == r.offloaded
        assert cascade.offload_ratio(records) == pytest.approx(off.mean())
    jc = jcore.Cascade.from_engine(lambda i: jstate.weak_dets_val[i],
                                   lambda i: jstate.strong_dets_val[i], jeng)
    jrec = jc.run(items)
    np.testing.assert_allclose(est, [r.estimate for r in jrec], atol=EST_TOL)
    np.testing.assert_array_equal(off[~near], np.array([r.offloaded for r in jrec])[~near])
    with pytest.raises(ValueError, match="fit"):
        tcore.Cascade.from_engine(lambda i: i, lambda i: i, OffloadEngine(device="cpu"))


@pytest.mark.parametrize("n_val", [64, 300])
def test_figure7_feature_maps_equal_repro(pipelines, n_val):
    """The port's cached weak detector over the regenerated val split (in
    256-image forwards: 300 takes two) gives repro's backbone feature maps
    from repro's cached weights."""
    import jax
    import jax.numpy as jnp

    from repro.data.shapes import ShapesDataset as JShapes
    from repro.models.detector import WEAK as JWEAK
    from repro.models.detector import detector_forward as j_forward
    from repro.models.detector import detector_init as j_init
    from repro.train.checkpoint import load_pytree as j_load_pytree

    _, _, _, tdir = pipelines
    jparams = j_load_pytree(str(tdir.parent / "repro" / "detector_weak.npz"),
                            j_init(jax.random.PRNGKey(0), JWEAK))
    images = JShapes.generate(n_val, seed=1).images
    want = np.concatenate([np.asarray(j_forward(jparams, JWEAK, jnp.asarray(images[s : s + 256]))[3])
                           for s in range(0, n_val, 256)])
    got = tdr.val_feature_maps(n_val, device="cpu", cache_dir=str(tdir))
    assert got.shape == want.shape and got.shape[0] == n_val and got.ndim == 4
    np.testing.assert_allclose(got, want, atol=EST_TOL)
    assert np.abs(want).max() > 0.1


@pytest.mark.parametrize("epochs", [2, 4])
def test_figure7_input_study_equals_repro(states, pipelines, repro_init, repro_cnn_init,
                                          monkeypatch, epochs):
    """Both packages' Fig. 7 from the same state, the same cached weak
    detector and repro's initial weights (MLP and CNN): the 2-fold split
    drawn after ``from_pool``, the out-of-fold estimates of both engines
    at the fit tolerance, and every curve point whose top-k mask is clear
    of a near tie equal."""
    jstate, pstate = states
    _, _, _, tdir = pipelines
    monkeypatch.setattr(jdr, "ARTIFACTS", str(tdir.parent / "repro"))
    seen = {"j": [], "t": []}
    for mod, key in ((jdr, "j"), (tdr, "t")):
        def spy(preds, ratio, _real=mod.topk_offload_mask, _key=key):
            seen[_key].append((np.array(preds, copy=True), ratio))
            return _real(preds, ratio)
        monkeypatch.setattr(mod, "topk_offload_mask", spy)
    ratios = (0.1, 0.3, 0.5)
    kw = dict(context_size=32, epochs=epochs, ratios=ratios, n_val=len(pstate.val_pairs))
    want = jdr.figure7_input_study(jstate, **kw)
    got = tdr.figure7_input_study(pstate, **kw, device="cpu", cache_dir=str(tdir))
    assert got["ratios"] == want["ratios"] == list(ratios)
    assert list(got["curves"]) == list(want["curves"]) == ["output_mlp", "featmap_cnn"]
    names = [n for n in want["curves"] for _ in ratios]
    assert len(seen["t"]) == len(seen["j"]) == len(names)
    clear = 0
    for i, ((gp, gr), (wp, wr), name) in enumerate(zip(seen["t"], seen["j"], names)):
        assert gr == wr
        np.testing.assert_allclose(gp, wp, atol=FIT_TOL, err_msg=name)
        k = int(round(wr * len(wp)))
        s = np.sort(wp)[::-1]
        if 0 < k < len(s) and s[k - 1] - s[k] > 2 * FIT_TOL:
            clear += 1
            assert got["curves"][name][i % len(ratios)] == want["curves"][name][i % len(ratios)]
    assert clear >= len(names) // 2
    for name in names:
        assert np.ptp(seen["j"][names.index(name)][0]) > 0, name  # the estimates vary


def test_figure7_input_study_runs_on_the_port(pipelines):
    """Fig. 7 on the port's own tiny pipeline: the feature maps come from
    the port's cached weak detector; both estimators fit on the CPU from
    the port's own draws."""
    _, tstate, _, tdir = pipelines
    out = tdr.figure7_input_study(tstate, context_size=32, epochs=2, ratios=(0.1, 0.5),
                                  n_val=len(tstate.val_pairs), device="cpu",
                                  cache_dir=str(tdir))
    assert out["ratios"] == [0.1, 0.5] and sorted(out["curves"]) == ["featmap_cnn", "output_mlp"]
    for curve in out["curves"].values():
        assert len(curve) == 2 and all(0.0 <= m <= 1.0 for m in curve)


def test_load_detector_is_the_trained_one(pipelines):
    _, tstate, _, tdir = pipelines
    weak = tdr.load_detector(tdr.WEAK, device="cpu", cache_dir=str(tdir))
    assert float(weak.head_out.bias.detach()[0]) == 3.0  # the sharpened head build_pipeline scored with


def test_run_all_writes_plain_json(pipelines, tmp_path):
    """``run_all`` on the cached tiny state: every figure, each stage timed,
    and a results file of plain Python numbers under the port's own name."""
    _, tstate, _, tdir = pipelines
    stage = {}
    res = tdr.run_all(quick=True, device="cpu", cache_dir=str(tdir), stage_ms=stage)
    assert set(res) == {"weak_map", "strong_map", "figure5", "table2", "figure6", "figure8",
                        "figure9_10", "streaming_multi_edge"}
    assert {"figure5_ms", "figure6_ms", "train_estimators_ms", "figure9_10_ms",
            "streaming_ms"} <= set(stage)
    assert res["weak_map"] == tstate.weak_map
    path = tdir / "torch_repro_results.json"
    assert json.loads(path.read_text()) == json.loads(json.dumps(res))

    def leaves(o):
        if isinstance(o, dict):
            for v in o.values():
                yield from leaves(v)
        elif isinstance(o, list):
            for v in o:
                yield from leaves(v)
        else:
            yield o

    assert all(type(v) in (float, int, bool, str, type(None)) for v in leaves(res))
    assert not (tdir / "repro_results.json").exists()
