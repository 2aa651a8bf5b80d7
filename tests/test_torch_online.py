"""The port's closed-loop adaptation (``repro_torch.online``) against
``repro.online`` on the CPU, case by case after ``tests/test_online.py``.

Tolerances:

* the copied numpy pieces (``StreamingQuantiles``, ``ReplayBuffer``,
  ``DriftDetector``, ``NetworkEstimator``, ``LastLayerSolver`` on one
  design matrix, the ``adaptive_threshold`` decisions): exact;
* ``hidden_features``: 1e-6 (float32 gemm and tanh-GELU; XLA and PyTorch
  sum in different orders), and the last-layer heads solved from each
  package's hidden features: 1e-6;
* ``mini_refit`` from one state and one permutation: the AdamW criterion
  of ``tests/test_torch_train.py``, every weight within 2 lr_sum and at
  most 1% beyond 1e-5, with the loss traces at 1e-5 relative;
* engines carried across as artifacts: estimates within 1e-5 (the MLP
  tolerance of ``tests/test_kernels.py``), every other state exact;
* the frozen arm of ``run_shift_scenario`` on ``repro``'s fitted engine:
  equal to ``repro``'s arm (offload masks, served frames, effective
  accuracy).  The adaptive arm is the port's own trajectory (its last-layer
  solves amplify the 1e-7 differences of the hidden features); the
  headline asserts of ``tests/test_online.py`` hold on it.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.detection.batch  # noqa: F401  (first: repro's kernels import it back)
import repro.online as jo
import repro.runtime as jrt
from repro.api import MLPRewardModel as JMLPRewardModel
from repro.api import OffloadEngine as JOffloadEngine
from repro.api import make_policy as j_make_policy
from repro.core import EstimatorConfig as JEstimatorConfig
from repro.core.reward import CdfTransform as JCdfTransform
from repro.runtime.edge import LatencyBreakdown as JLatencyBreakdown

from repro_torch.api import OffloadEngine, list_policies, make_policy
from repro_torch.core.reward import CdfTransform
from repro_torch.online import (
    AdaptiveEngine,
    DriftConfig,
    DriftDetector,
    LastLayerSolver,
    NetworkEstimator,
    OnlineConfig,
    ReplayBuffer,
    StreamingQuantiles,
    apply_last_layer,
    clone_engine,
    default_shift_scenario,
    hidden_features,
    mini_refit,
    reward_to_logit,
    run_shift_scenario,
)
from repro_torch.runtime import default_congested_fleet, simulate
from repro_torch.runtime.edge import LatencyBreakdown

EST_TOL = 1e-5  # tests/test_kernels.py's MLP tolerance
HIDDEN_TOL = 1e-6


def same_state(got, want):
    """Two ``state()`` dicts of numpy arrays: equal keys, values, dtypes."""
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and np.array_equal(g, w, equal_nan=True), k


# ---------------------------------------------------------------------------
# copied numpy: quantiles, buffer, drift, network state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_markers,warm", [(65, 0), (33, 200), (9, 5)])
def test_streaming_quantiles_equal_repro(n_markers, warm):
    rng = np.random.default_rng(n_markers)
    got, want = StreamingQuantiles(n_markers), jo.StreamingQuantiles(n_markers)
    if warm:
        sample = rng.normal(0.0, 1.0, warm)
        got.warm_start(sample)
        want.warm_start(sample)
    stream = np.concatenate([rng.normal(0, 1, 300), rng.normal(3, 0.5, 300), [np.nan, np.inf]])
    for i, x in enumerate(stream):
        got.update(float(x))
        want.update(float(x))
        if i % 97 == 0:
            same_state(got.state(), want.state())
    same_state(got.state(), want.state())
    for q in (0.0, 0.1, 0.5, 0.9, 1.0):
        assert got.quantile(q) == want.quantile(q)
    np.testing.assert_array_equal(got.calibration_scores(), want.calibration_scores())
    clone = StreamingQuantiles.from_state(want.state())
    same_state(clone.state(), got.state())


def test_streaming_quantiles_transform_roundtrip_equals_repro():
    sample = np.random.default_rng(3).normal(0.0, 1.0, 800)
    got = StreamingQuantiles.from_transform(CdfTransform(sample), n_markers=65)
    want = jo.StreamingQuantiles.from_transform(JCdfTransform(sample), n_markers=65)
    same_state(got.state(), want.state())
    grid = np.linspace(-2.0, 2.0, 41)
    np.testing.assert_array_equal(got.to_transform()(grid), want.to_transform()(grid))
    with pytest.raises(RuntimeError):
        StreamingQuantiles(9).quantile(0.5)


def test_replay_buffer_equals_repro():
    rng = np.random.default_rng(1)
    got, want = ReplayBuffer(5, 3), jo.ReplayBuffer(5, 3)
    for n in (1, 3, 4, 2):
        x, y = rng.normal(size=(n, 3)), rng.normal(size=n)
        got.append(x, y)
        want.append(x, y)
        for a, b in zip(got.data(), want.data()):
            np.testing.assert_array_equal(a, b)
    got.append(np.ones(3), 2.0)
    want.append(np.ones(3), 2.0)
    same_state(got.state(), want.state())
    same_state(ReplayBuffer.from_state(want.state()).state(), got.state())
    with pytest.raises(ValueError):
        got.append(np.zeros((2, 3)), np.zeros(3))
    with pytest.raises(ValueError):
        got.append(np.zeros((2, 4)), np.zeros(2))


@pytest.mark.parametrize("cfg", [dict(), dict(alpha=0.2, k=0.25, h=4.0, widen=1.5)])
def test_drift_detector_equals_repro(cfg):
    rng = np.random.default_rng(2)
    got, want = DriftDetector(DriftConfig(**cfg)), jo.DriftDetector(jo.DriftConfig(**cfg))
    residuals = np.concatenate([-0.12 + 0.05 * rng.normal(size=150),
                                0.3 + 0.05 * rng.normal(size=80)])
    for i, r in enumerate(residuals):
        assert got.update(0.1, r) == want.update(0.1, r)
        assert (got.drifted, got.statistic, got.ratio_multiplier(), got.confidence()) == (
            want.drifted, want.statistic, want.ratio_multiplier(), want.confidence())
        if i == 60:
            got.rebaseline()
            want.rebaseline()
        if got.drifted:
            got.reset()
            want.reset()
    assert got.events > 0
    same_state(got.state(), want.state())
    clone = DriftDetector.from_state(want.state(), DriftConfig(**cfg))
    same_state(clone.state(), got.state())


def test_network_estimator_equals_repro():
    """A seeded stream of completions on a manual clock: every estimator
    and probe equal, during and after, and the state round-trips."""
    rng = np.random.default_rng(4)
    clk = {"t": 0.0}
    got = NetworkEstimator(parallelism=2, clock=lambda: clk["t"])
    want = jo.NetworkEstimator(parallelism=2, clock=lambda: clk["t"])
    for i in range(60):
        q, tx, sv = rng.uniform(0, 2), rng.uniform(0.5, 4), rng.uniform(0.1, 1)
        bits = float(rng.integers(1, 4))
        got.record(clk["t"], q + tx + sv, LatencyBreakdown(q, tx, sv), bits=bits)
        want.record(clk["t"], q + tx + sv, JLatencyBreakdown(q, tx, sv), bits=bits)
        if i % 7 == 0:
            got.record(clk["t"], float("nan"))
            want.record(clk["t"], -1.0)
        clk["t"] += float(rng.uniform(0.2, 2.0))
        assert got.telemetry() == want.telemetry()
        assert got.state_probe() == want.state_probe()
        assert got.rto() == want.rto()
    same_state(got.state(), want.state())
    clone = NetworkEstimator.from_state(want.state(), parallelism=2, clock=lambda: clk["t"])
    clk["t"] += 100.0
    assert clone.telemetry() == got.telemetry()


@pytest.mark.parametrize("ratio", [0.0, 0.3, 0.7, 1.0])
def test_adaptive_threshold_equals_repro(ratio):
    assert "adaptive_threshold" in list_policies()
    rng = np.random.default_rng(6)
    cal, est = rng.normal(0.0, 1.0, 128), rng.normal(2.0, 1.0, 600)
    got = make_policy("adaptive_threshold", cal, ratio, n_markers=17)
    want = j_make_policy("adaptive_threshold", cal, ratio, n_markers=17)
    np.testing.assert_array_equal(got.decide_batch(est), want.decide_batch(est))
    assert got.spec() == want.spec()


# ---------------------------------------------------------------------------
# model updates on an engine carried across
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """repro's small fitted engine (the fused-MLP shape) and the port's load
    of its artifact."""
    rng = np.random.default_rng(0)
    x = rng.normal(0.0, 1.0, (256, 12)).astype(np.float32)
    r = 1.5 * x[:, 0] - 0.5 * x[:, 1] + 0.2 * rng.normal(size=256)
    jeng = JOffloadEngine(
        reward_model=JMLPRewardModel(
            config=JEstimatorConfig(hidden=(16,), epochs=8, batch_size=64, seed=0)
        ),
        ratio=0.3,
    )
    jeng.fit(features=x, rewards=r)
    path = str(tmp_path_factory.mktemp("online") / "engine")
    jeng.save(path)
    return jeng, path, x


def port_engine(fitted):
    return OffloadEngine.load(fitted[1], device="cpu")


def test_hidden_features_equal_repro(fitted):
    jeng, _, x = fitted
    eng = port_engine(fitted)
    got = hidden_features(eng.reward_model, x)
    want = jo.hidden_features(jeng.reward_model, x)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=HIDDEN_TOL, rtol=0)
    # tanh GELU: the exact form differs from it by ~1e-4 here
    assert np.abs(got - torch.nn.functional.gelu(torch.as_tensor(
        (x - eng.reward_model.estimator._mu) / eng.reward_model.estimator._sigma)
        @ eng.reward_model.estimator.params["layer0"]["w"]
        + eng.reward_model.estimator.params["layer0"]["b"]).numpy()).max() > 10 * HIDDEN_TOL


def test_last_layer_solver_equals_repro(fitted):
    """The solver is copied numpy: bit-equal on one design matrix; heads
    solved from each package's hidden features within 1e-6; the installed
    head scores as the ridge solution does."""
    jeng, _, x = fitted
    eng = port_engine(fitted)
    h, jh = hidden_features(eng.reward_model, x), jo.hidden_features(jeng.reward_model, x)
    rng = np.random.default_rng(4)
    y = 1.0 / (1.0 + np.exp(-(jh @ rng.normal(0.0, 0.5, jh.shape[1]) + 0.3)))
    heads = []
    for forget in (1.0, 0.7):
        solvers = [LastLayerSolver(16, l2=1e-2, forget=forget),
                   jo.LastLayerSolver(16, l2=1e-2, forget=forget),
                   LastLayerSolver(16, l2=1e-2, forget=forget)]
        for lo in range(0, 256, 64):
            for s, feats in zip(solvers, (jh, jh, h)):
                s.ingest(feats[lo : lo + 64], reward_to_logit(y[lo : lo + 64]))
        (w0, b0), (w1, b1), (w2, b2) = (s.solve() for s in solvers)
        np.testing.assert_array_equal(w0, w1)
        assert b0 == b1
        same_state(solvers[0].state(), solvers[1].state())
        np.testing.assert_allclose(w2, w1, atol=HIDDEN_TOL, rtol=0)
        assert abs(b2 - b1) <= HIDDEN_TOL
        heads.append((w2, b2))
    np.testing.assert_array_equal(reward_to_logit(y), jo.reward_to_logit(y))
    w, b = heads[0]
    apply_last_layer(eng.reward_model, w, b)
    want = 1.0 / (1.0 + np.exp(-(h.astype(np.float64) @ w + b)))
    np.testing.assert_allclose(eng.score(features=x), want, atol=EST_TOL)
    with pytest.raises(RuntimeError):
        LastLayerSolver(4).solve()
    with pytest.raises(ValueError):
        LastLayerSolver(4, forget=0.0)


@pytest.mark.parametrize("epochs,batch_size,seed", [(2, 128, 0), (3, 48, 5)])
def test_mini_refit_equals_repro(fitted, epochs, batch_size, seed):
    """From repro's fitted weights, over the same rows and the same numpy
    permutations: loss traces at 1e-5 relative, weights within the AdamW
    criterion of tests/test_torch_train.py."""
    jeng, _, x = fitted
    jmodel = jo.clone_engine(jeng).reward_model
    model = port_engine(fitted).reward_model
    y = np.random.default_rng(9).uniform(0, 1, 256).astype(np.float32)
    lr = 5e-4
    jl = jo.mini_refit(jmodel, x, y, epochs=epochs, lr=lr, batch_size=batch_size, seed=seed)
    tl = mini_refit(model, x, y, epochs=epochs, lr=lr, batch_size=batch_size, seed=seed)
    assert len(tl) == len(jl) == epochs * -(-256 // batch_size)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    lr_sum = lr * len(tl)
    far = size = 0
    jp, tp = jmodel.estimator.params, model.estimator.params
    for layer in jp:
        for k in jp[layer]:
            g, w = tp[layer][k].numpy(), np.asarray(jp[layer][k])
            np.testing.assert_allclose(g, w, atol=2 * lr_sum, rtol=0, err_msg=f"{layer}.{k}")
            far += int((np.abs(g - w) > 1e-5).sum())
            size += w.size
    assert far / size <= 0.01, (far, size)
    np.testing.assert_allclose(model.predict(x), jmodel.predict(x), atol=2 * lr_sum)


def test_clone_engine_stays_on_device_and_is_independent(fitted):
    eng = port_engine(fitted)
    clone = clone_engine(eng)
    assert clone.device == eng.device and clone.device.type == "cpu"
    assert clone.reward_model.estimator.params["layer1"]["w"].device.type == "cpu"
    apply_last_layer(clone.reward_model, np.zeros(16), 0.0)
    assert not np.array_equal(clone.score(features=fitted[2]), eng.score(features=fitted[2]))


# ---------------------------------------------------------------------------
# AdaptiveEngine
# ---------------------------------------------------------------------------

_FAST = dict(
    buffer_capacity=64,
    min_observations=8,
    update_every=4,
    refit_every=24,
    refit_epochs=2,
    seed=0,
)


def _observation_stream(x, seed, n):
    """Deterministic (features, estimate, reward) triples for feedback;
    the estimates are fixed numbers, so both packages see the same."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, x.shape[0], n)
    return x[idx], rng.uniform(0, 1, n), rng.uniform(-0.5, 1.5, n)


def _feed(ada, x, seeds, n=6):
    reports = []
    for s in seeds:
        ada.observe(*_observation_stream(x, s, n))
        ada.maybe_update()
        reports.append(ada.maybe_update())
    return reports


def _counters(ada):
    return (ada.observations, ada.incremental_updates, ada.refits, ada.drift_events,
            ada._since_update, ada._since_refit, ada._unsolved_lo)


def test_adaptive_engine_cadence_equals_repro(fitted):
    """The same observation stream through both wrappers: the same cadence
    (reports, counters), equal buffers, trackers and drift state, and the
    refreshed calibration and estimates within the MLP tolerance."""
    jeng, _, x = fitted
    got = AdaptiveEngine(port_engine(fitted), OnlineConfig(**_FAST))
    want = jo.AdaptiveEngine(jo.clone_engine(jeng), jo.OnlineConfig(**_FAST))
    for s in range(5):
        xs, est, rw = _observation_stream(x, 20 + s, 6)
        got.observe(xs, est, rw)
        want.observe(xs, est, rw)
        got.observe_estimates(est)
        want.observe_estimates(est)
        assert dataclasses.astuple(got.maybe_update()) == dataclasses.astuple(want.maybe_update())
        assert _counters(got) == _counters(want)
    assert got.refits >= 1 and got.incremental_updates >= 1
    same_state(got.buffer.state(), want.buffer.state())
    same_state(got.drift.state(), want.drift.state())
    same_state(got.reward_tracker.state(), want.reward_tracker.state())
    same_state(got.score_tracker.state(), want.score_tracker.state())
    np.testing.assert_allclose(got.engine.score(features=x), want.engine.score(features=x),
                               atol=EST_TOL)


def test_adaptive_engine_checkpoints_cross_both_ways(fitted, tmp_path):
    """A checkpoint either package saves loads in the other with the same
    online state and (within the MLP tolerance) the same estimates."""
    jeng, _, x = fitted
    jada = jo.AdaptiveEngine(jo.clone_engine(jeng), jo.OnlineConfig(**_FAST))
    _feed(jada, x, range(30, 33))
    jpath = str(tmp_path / "from_repro.npz")
    jada.save(jpath)
    got = AdaptiveEngine.load(jpath, device="cpu")
    ada = AdaptiveEngine(port_engine(fitted), OnlineConfig(**_FAST))
    _feed(ada, x, range(30, 33))
    tpath = str(tmp_path / "from_port.npz")
    ada.save(tpath)
    back = jo.AdaptiveEngine.load(tpath)
    for a, b in ((got, jada), (ada, back)):
        assert a.config.as_meta() == b.config.as_meta()
        assert _counters(a) == _counters(b)
        assert a.base_ratio == b.base_ratio
        for name in ("buffer", "score_tracker", "drift", "reward_tracker", "solver"):
            same_state(getattr(a, name).state(), getattr(b, name).state())
        np.testing.assert_allclose(a.engine.score(features=x), b.engine.score(features=x),
                                   atol=EST_TOL)
    assert got.engine.device.type == "cpu"
    plain = str(tmp_path / "plain.npz")
    port_engine(fitted).save(plain)
    with pytest.raises(ValueError):
        AdaptiveEngine.load(plain, device="cpu")


def test_adaptive_engine_replay_from_checkpoint_is_bit_identical(fitted, tmp_path):
    eng = port_engine(fitted)
    x = fitted[2]
    ada = AdaptiveEngine(clone_engine(eng), OnlineConfig(**_FAST))
    for i in range(4):
        ada.observe(*_observation_stream(x, 40 + i, 5))
        ada.maybe_update()
    path = str(tmp_path / "mid.npz")
    ada.save(path)
    back = AdaptiveEngine.load(path, device="cpu")
    tail = [_observation_stream(x, 50 + i, 5) for i in range(6)]
    for arm in (ada, back):
        for xs, est, rw in tail:
            arm.observe(xs, est, rw)
            arm.maybe_update()
    assert back.refits == ada.refits and back.refits >= 1
    assert back.incremental_updates == ada.incremental_updates
    a_params = ada.engine.reward_model.estimator.params
    b_params = back.engine.reward_model.estimator.params
    for layer in a_params:
        for leaf in a_params[layer]:
            assert torch.equal(a_params[layer][leaf], b_params[layer][leaf])
    np.testing.assert_array_equal(ada.engine.score(features=x), back.engine.score(features=x))
    assert ada.drift.statistic == back.drift.statistic


def test_adaptive_engine_obs_counters(fitted):
    from repro_torch.obs import Obs

    obs = Obs()
    ada = AdaptiveEngine(port_engine(fitted), OnlineConfig(**_FAST), obs=obs)
    _feed(ada, fitted[2], range(60, 66))
    text = obs.metrics.to_prometheus()
    assert 'repro_adaptive_updates_total{kind="incremental"}' in text
    assert ada.incremental_updates >= 1 and ada.refits >= 1
    assert obs.profiler.report()["online.incremental"]["count"] == ada.incremental_updates


# ---------------------------------------------------------------------------
# measured network state on the runtime
# ---------------------------------------------------------------------------


def test_measured_netstate_trace_equals_repro(tmp_path):
    """simulate under queue_aware with the oracle probes and with a
    NetworkEstimator on repro's engine: each trace equals repro's, and the
    measured probes cost at most 5% latency against the oracle (the
    acceptance of tests/test_online.py)."""
    rng = np.random.default_rng(0)
    x = rng.normal(0.0, 1.0, (512, 32)).astype(np.float32)
    r = 2.0 * x[:, 0] + 0.3 * rng.normal(size=512)
    jeng = JOffloadEngine(
        reward_model=JMLPRewardModel(
            config=JEstimatorConfig(hidden=(16,), epochs=10, batch_size=64)
        ),
        ratio=0.3,
    )
    jeng.fit(features=x, rewards=r)
    path = str(tmp_path / "engine")
    jeng.save(path)
    qa, jqa = OffloadEngine.load(path, device="cpu").with_policy("queue_aware"), \
        jeng.with_policy("queue_aware")
    results = {}
    for label, nets in (("oracle", (None, None)),
                        ("measured", (NetworkEstimator(), jo.NetworkEstimator()))):
        kw = dict(features=x, ratio=0.3, micro_batch=1, seed=0)
        got = simulate(qa, edges=default_congested_fleet(3, seed=0), net_state=nets[0], **kw)
        want = jrt.simulate(jqa, edges=jrt.default_congested_fleet(3, seed=0),
                            net_state=nets[1], **kw)
        for g, w in zip(got.records, want.records, strict=True):
            g, w = g.as_dict(), w.as_dict()
            assert g.pop("estimate") == pytest.approx(w.pop("estimate"), abs=EST_TOL)
            assert g == w
        if nets[0] is not None:
            assert nets[0].telemetry() == nets[1].telemetry()
        off = [rec.latency for rec in got.records if rec.outcome == "offloaded"]
        results[label] = (float(np.mean(off)),
                          float(np.mean([(rec.latency or 0.0) for rec in got.records])),
                          len(off))
    oracle, measured = results["oracle"], results["measured"]
    assert measured[0] <= oracle[0] * 1.05
    assert measured[1] <= oracle[1] * 1.05
    assert abs(measured[2] - oracle[2]) <= 0.1 * oracle[2]


# ---------------------------------------------------------------------------
# the distribution-shift headline
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shift(tmp_path_factory):
    """repro's shift scenario and its arms, and the port's scenario serving
    repro's fitted engine (an artifact on disk) with its arms."""
    jscn = jo.default_shift_scenario()
    path = str(tmp_path_factory.mktemp("shift") / "engine")
    jscn.engine.save(path)
    scn = default_shift_scenario(device="cpu")
    scn.engine = OffloadEngine.load(path, device="cpu")
    return (jscn, jo.run_shift_scenario(jscn)), (
        scn, run_shift_scenario(scn), run_shift_scenario(scn, adaptive=True))


def test_shift_scenario_equals_repro(shift):
    (jscn, _), (scn, _, _) = shift
    np.testing.assert_array_equal(scn.weak_ap, jscn.weak_ap)
    np.testing.assert_array_equal(scn.strong_ap, jscn.strong_ap)
    np.testing.assert_allclose(scn.features.numpy(), jscn.features, atol=EST_TOL)
    assert (scn.shift_at, scn.n_frames, scn.n_streams) == (jscn.shift_at, 160, 4)


def test_frozen_arm_equals_repro(shift):
    (_, jfrozen), (_, frozen, _) = shift
    np.testing.assert_array_equal(frozen.offload, jfrozen.offload)
    np.testing.assert_array_equal(frozen.served_strong, jfrozen.served_strong)
    np.testing.assert_array_equal(frozen.effective, jfrozen.effective)
    assert frozen.summary() == jfrozen.summary()
    for g, w in zip(frozen.telemetry, jfrozen.telemetry, strict=True):
        assert g.pop("mean_estimate") == pytest.approx(w.pop("mean_estimate"), abs=EST_TOL)
        assert g == w


def test_headline_adaptive_recovers_post_shift_accuracy(shift):
    _, (_, frozen, adaptive) = shift
    assert adaptive.mean_effective(post_shift=True) > frozen.mean_effective(post_shift=True)
    assert abs(adaptive.realized_ratio() - frozen.realized_ratio()) <= 0.05


def test_headline_adaptive_arm_actually_adapted(shift):
    _, (_, _, adaptive) = shift
    up = adaptive.updates
    assert up["observations"] > 0 and up["incremental_updates"] > 0 and up["refits"] > 0
    handle = adaptive.adaptive
    assert handle is not None and handle.observations == up["observations"]


def test_headline_frames_served_strong_only_when_offloaded(shift):
    _, (_, frozen, adaptive) = shift
    for run in (frozen, adaptive):
        assert not np.any(run.served_strong & ~run.offload)
    assert frozen.updates == {}


def test_headline_sessions_report_online_telemetry(shift):
    _, (_, _, adaptive) = shift
    for tele in adaptive.telemetry:
        assert tele["rtt_samples"] > 0 and tele["mean_rtt"] > 0.0
        assert tele["online_updates"] > 0


def test_shift_scenario_guards():
    with pytest.raises(ValueError):
        default_shift_scenario(n_frames=10, shift_at=10, device="cpu")
