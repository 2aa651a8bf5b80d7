"""The port's city-scale fleet (``repro_torch.fleet``) against ``repro.fleet``
on the CPU, case by case after ``tests/test_fleet.py`` and the plane tests of
``tests/test_sharding.py``.

The same seeds and numpy inputs go to both packages.  Tolerances:

* ``FleetBudget`` and the ``fleet_fair`` policy: exact (copied numpy);
* ``simulate_fleet`` and the city arms: ``repro`` fits and saves the engine,
  the port loads the artifact (``OffloadEngine.load(device="cpu")``); step
  records (decisions, outcomes, latencies) and every integer of the
  telemetry, dispatcher and budget exactly, estimates and the floats that
  sum them within 1e-5 (the MLP tolerance of ``tests/test_kernels.py``);
* the city headline: ``tests/test_fleet.py``'s asserts at its size, on the
  port serving ``repro``'s engine;
* ``FleetPlane`` over ``["cpu"] * 4``: bit for bit the single-device calls
  (``engine.score``, ``engine.score_device``, ``match_batch``,
  ``extract_features_batch``) at ragged batch sizes, as ``repro``'s plane
  is held in ``tests/test_sharding.py``.
"""
import math

import numpy as np
import pytest

import repro.detection.batch  # noqa: F401  (first: repro's kernels import it back)
import repro.fleet as jf
from repro.api import MLPRewardModel as JMLPRewardModel
from repro.api import OffloadEngine as JOffloadEngine
from repro.api import make_policy as j_make_policy
from repro.core import EstimatorConfig as JEstimatorConfig
from repro.runtime import ManualClock as JManualClock

from repro_torch.api import (
    DetectionBoxFeatures,
    MLPRewardModel,
    OffloadEngine,
    list_policies,
    make_policy,
)
from repro_torch.core import EstimatorConfig
from repro_torch.core.features import extract_features_batch
from repro_torch.detection.batch import DetectionsBatch, GroundTruthBatch, match_batch
from repro_torch.detection.map_engine import Detections, GroundTruth
from repro_torch.fleet import (
    FleetBudget,
    FleetPlane,
    FleetRuntime,
    default_city_scenario,
    run_city_scenario,
    simulate_fleet,
)
from repro_torch.launch.mesh import make_fleet_mesh
from repro_torch.obs import kernel_stats
from repro_torch.runtime import ManualClock, OffloadSession

EST_TOL = 1e-5  # tests/test_kernels.py's MLP tolerance
CPU4 = ["cpu"] * 4


def fit_pair(tmp_path, policy="threshold", ratio=0.3, n=256, d=12, seed=0):
    """``tests/test_fleet.py``'s engine fitted by ``repro``, and the port's
    load of its artifact; with the features."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    rewards = 2.0 * x[:, 0] + 0.3 * rng.normal(size=n)
    jeng = JOffloadEngine(
        reward_model=JMLPRewardModel(
            config=JEstimatorConfig(hidden=(16,), epochs=15, batch_size=64)
        ),
        policy=policy,
        ratio=ratio,
    )
    jeng.fit(features=x, rewards=rewards)
    path = str(tmp_path / "fleet_engine")
    jeng.save(path)
    return jeng, OffloadEngine.load(path, device="cpu"), x


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    return fit_pair(tmp_path_factory.mktemp("fleet"))


def assert_close_tree(got, want, path="", tol=EST_TOL):
    """Nested dicts / lists / tuples equal, floats within ``tol`` (absolute
    and relative), nan equal to nan; everything else exactly."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_close_tree(got[k], want[k], f"{path}.{k}", tol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close_tree(g, w, f"{path}[{i}]", tol)
    elif isinstance(want, float) and not isinstance(got, bool):
        if math.isnan(want):
            assert math.isnan(got), path
        else:
            assert got == pytest.approx(want, rel=tol, abs=tol), path
    else:
        assert got == want, path


def same_fleet_trace(got, want):
    """Two ``FleetTrace``s: step records equal (estimates within 1e-5),
    telemetry, dispatcher and budget equal (their floats within 1e-5)."""
    assert len(got.steps) == len(want.steps)
    for g, w in zip(got.steps, want.steps):
        assert g.t == w.t
        np.testing.assert_array_equal(g.offload, w.offload)
        np.testing.assert_array_equal(g.outcome, w.outcome)
        np.testing.assert_array_equal(g.latency, w.latency)  # nan where not offloaded
        np.testing.assert_allclose(g.estimates, w.estimates, rtol=0, atol=EST_TOL)
    assert_close_tree(got.telemetry.as_dict(include_per_shard=True),
                      want.telemetry.as_dict(include_per_shard=True), "telemetry")
    assert_close_tree(got.dispatcher, want.dispatcher, "dispatcher")
    assert_close_tree(got.budget, want.budget, "budget")


def same_bits(got, want):
    """Two runs of the port: every record and report bit for bit."""
    for g, w in zip(got.steps, want.steps):
        for f in ("estimates", "offload", "outcome", "latency"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
    assert len(got.steps) == len(want.steps)
    assert got.telemetry == want.telemetry
    assert got.dispatcher == want.dispatcher and got.budget == want.budget


# ------------------------------------------------------------ fleet budget


def _skewed_rewards(budgets):
    for b in budgets:
        for shard, score in enumerate((0.05, 0.2, 0.5, 0.9)):
            for _ in range(8):
                b.record_reward(shard, score)


def _only_shard0(budgets):
    for b in budgets:
        for _ in range(16):
            b.record_reward(0, 1.0)


def _congestion_shock(budgets):
    for b in budgets:
        for shard in range(4):
            for _ in range(8):
                b.record_reward(shard, 0.5)
                b.record_congestion(shard, 8.0 if shard == 0 else 0.5)


def _stale_shard2(budgets):
    for b in budgets:
        for shard in range(4):
            for _ in range(8):
                b.record_reward(shard, 0.5)
                b.record_staleness(shard, 9.0 if shard == 2 else 1.0)


BUDGET_CASES = {
    "conserves_total_rate": (dict(total_rate=16.0, depth=8.0, smooth=1.0), _skewed_rewards),
    "min_share_floor": (dict(total_rate=8.0, smooth=1.0, min_share=0.4), _only_shard0),
    "congestion_shock": (dict(total_rate=16.0, smooth=1.0, congestion_weight=0.5,
                              staleness_weight=0.5), _congestion_shock),
    "congestion_off": (dict(total_rate=16.0, smooth=1.0, congestion_weight=0.0,
                            staleness_weight=0.0), _congestion_shock),
    "staleness_boost": (dict(total_rate=16.0, smooth=1.0, congestion_weight=0.0,
                             staleness_weight=0.5), _stale_shard2),
    "static": (dict(total_rate=8.0, redistribute_every=None), _only_shard0),
}


@pytest.mark.parametrize("case", sorted(BUDGET_CASES))
def test_fleet_budget_equals_repro(case):
    """The same records and clock ticks through both packages' budgets give
    the same shares, rates, levels and stats, exactly."""
    kw, feed = BUDGET_CASES[case]
    kw = dict(kw)
    rate = kw.pop("total_rate")
    kw.setdefault("redistribute_every", 1.0)
    jclock, tclock = JManualClock(), ManualClock()
    jb = jf.FleetBudget(rate, 4, clock=jclock, **kw)
    tb = FleetBudget(rate, 4, clock=tclock, **kw)
    feed([jb, tb])
    for _ in range(4):
        assert tb.maybe_redistribute(tclock()) == jb.maybe_redistribute(jclock())
        for clock in (jclock, tclock):
            clock.advance(1.0)
        for shard in range(4):
            assert tb.try_take(shard) == jb.try_take(shard)
            assert tb.allocated_ratio(shard, 0.25) == jb.allocated_ratio(shard, 0.25)
    assert np.array_equal(tb.shares, jb.shares)
    assert [b.rate for b in tb.buckets] == [b.rate for b in jb.buckets]
    assert tb.stats() == jb.stats()
    assert np.isclose(sum(b.rate for b in tb.buckets), rate)
    if kw["redistribute_every"] is None:
        assert tb.redistributions == 0 and list(tb.shares) == [0.25] * 4
    else:
        assert tb.redistributions >= 1


def test_fleet_budget_validates():
    with pytest.raises(ValueError):
        FleetBudget(8.0, 0)
    with pytest.raises(ValueError):
        FleetBudget(-1.0, 2)
    with pytest.raises(ValueError):
        FleetBudget(8.0, 2, min_share=1.5)


# ------------------------------------------------------- fleet_fair policy


def test_fleet_fair_registered():
    assert {"fleet_fair", "mobility_aware"} <= set(list_policies())


def _policy_pair(cal, ratio, **kw):
    budgets = kw.pop("budget", None)
    jkw, tkw = dict(kw), dict(kw)
    if budgets is not None:
        jkw["budget"], tkw["budget"] = budgets
    return (j_make_policy("fleet_fair", cal, ratio, **jkw),
            make_policy("fleet_fair", cal, ratio, **tkw))


@pytest.mark.parametrize("case", ["no_budget", "skewed_window", "token_refusal"])
def test_fleet_fair_decisions_equal_repro(case):
    """``tests/test_fleet.py``'s three policy streams: the port decides each
    item as ``repro`` does, and ``repro``'s asserts hold on its decisions."""
    rng = np.random.default_rng({"no_budget": 0, "skewed_window": 1, "token_refusal": 2}[case])
    cal = rng.uniform(0, 1, 512)
    if case == "no_budget":
        jp, tp = _policy_pair(cal, 0.3)
        xs = rng.uniform(0, 1, 2000)
        mask = tp.decide_batch(xs)
        assert np.array_equal(mask, jp.decide_batch(xs))
        assert abs(mask.mean() - 0.3) < 0.03
    elif case == "skewed_window":
        jp, tp = _policy_pair(cal, 0.25, window=256, warmup=64)
        xs = rng.uniform(0, 0.2, 4000)
        mask = tp.decide_batch(xs)
        assert np.array_equal(mask, jp.decide_batch(xs))
        steady = mask[1000:]
        assert abs(steady.mean() - 0.25) < 0.03
        assert xs[1000:][steady].mean() > xs[1000:][~steady].mean() + 0.05
    else:
        jclock, tclock = JManualClock(), ManualClock()
        budgets = (jf.FleetBudget(0.125, 1, depth=4.0, clock=jclock),
                   FleetBudget(0.125, 1, depth=4.0, clock=tclock))
        jp, tp = _policy_pair(cal, 0.25, budget=budgets, shard=0)
        xs = rng.uniform(0, 1, 3000)
        taken = []
        for i, x in enumerate(xs):
            got = tp.decide(float(x))
            assert got == jp.decide(float(x)), i
            if got:
                taken.append((i, x))
            jclock.advance(1.0)
            tclock.advance(1.0)
        assert tp.denied == jp.denied and tp.denied > 100
        assert len(taken) / len(xs) < 0.25 * 0.75
        assert np.mean([x for i, x in taken if i >= 500]) > 0.82
    assert tp.spec() == jp.spec()


def test_fleet_fair_rejects_bad_shard():
    budget = FleetBudget(8.0, 2, clock=ManualClock())
    with pytest.raises(ValueError):
        make_policy("fleet_fair", np.ones(8), 0.3, budget=budget, shard=5)


def test_fleet_fair_artifact_strips_runtime_wiring(engines, tmp_path):
    """``budget`` / ``shard`` / ``clock`` are context parameters: the saved
    artifact keeps ``gain`` only, and ``repro`` loads it as its own."""
    _, eng, _ = engines
    budget = FleetBudget(8.0, 4, clock=ManualClock())
    clone = eng.with_policy(
        "fleet_fair", ratio=0.3, policy_kwargs={"gain": 0.1, "budget": budget, "shard": 2}
    )
    _, meta = clone.artifact_state()
    assert meta["policy"] == {"name": "fleet_fair", "kwargs": {"gain": 0.1}}
    path = str(tmp_path / "fair")
    clone.save(path)
    back = JOffloadEngine.load(path)
    assert back.policy_name == "fleet_fair" and back.policy_kwargs == {"gain": 0.1}


# -------------------------------------------------- submit_scored session


def test_submit_scored_matches_submit_batch(engines):
    """Centrally-scored fan-out (the fleet seam) decides exactly like the
    session scoring the same frames itself."""
    _, eng, x = engines
    a = OffloadSession(eng, micro_batch=8)
    ref = a.submit_batch(features=x[:64])
    b = OffloadSession(eng, micro_batch=8)
    scores = np.asarray(eng.score(features=x[:64]), np.float64).ravel()
    got = []
    for lo in range(0, 64, 16):
        got.extend(b.submit_scored(scores[lo : lo + 16]))
    assert [d.offload for d in got] == [d.offload for d in ref]
    assert [d.step for d in got] == [d.step for d in ref]
    np.testing.assert_array_equal([d.estimate for d in got], [d.estimate for d in ref])
    assert a.telemetry.as_dict() == b.telemetry.as_dict()


def test_submit_scored_refuses_pending_unscored(engines):
    _, eng, x = engines
    session = OffloadSession(eng, micro_batch=8)
    session.submit(features=x[0])  # buffered, unscored
    with pytest.raises(RuntimeError, match="flush"):
        session.submit_scored(np.array([0.5]))
    session.flush()
    assert session.submit_scored(np.array([0.5]))


# ----------------------------------------------------------- FleetRuntime


@pytest.mark.parametrize("kw", [
    dict(n_shards=4, ratio=0.3, seed=0),
    dict(n_shards=4, ratio=0.3, redistribute_every=2.0, seed=7),
    dict(n_shards=2, ratio=0.2, redistribute_every=1.0, edges_per_shard=2, seed=3),
], ids=["static", "coordinated", "two_shards"])
def test_simulate_fleet_equals_repro(engines, kw):
    """A seeded ``simulate_fleet`` on ``repro``'s engine: the port's trace
    equals ``repro``'s, and the port's over the four-shard CPU plane equals
    its own bit for bit."""
    jeng, eng, _ = engines
    feats = np.random.default_rng(4).normal(0, 1, (8, 32, 12)).astype(np.float32)
    want = jf.simulate_fleet(jeng, feats, **kw)
    got = simulate_fleet(eng, feats, **kw)
    same_fleet_trace(got, want)
    assert got.summary()["outcomes"] == want.summary()["outcomes"]
    same_bits(simulate_fleet(eng, feats, plane=FleetPlane(CPU4), **kw), got)


def test_fleet_runtime_smoke(engines):
    _, eng, _ = engines
    feats = np.random.default_rng(3).normal(0, 1, (8, 32, 12)).astype(np.float32)
    trace = simulate_fleet(eng, feats, n_shards=4, ratio=0.3, seed=0)
    t = trace.telemetry
    assert t.n_streams == 32 and t.n_shards == 4 and t.processed == 8 * 32
    assert t.offloaded == int(trace.decision_mask().sum())
    assert t.realized_ratio == pytest.approx(t.offloaded / t.processed)
    assert len(t.per_shard) == 4 and all("budget_share" in d for d in t.per_shard)
    assert not np.any(trace.offload_mask() & ~trace.decision_mask())
    assert set(trace.dispatcher) == {f"shard{i}" for i in range(4)}
    summary = trace.summary()
    assert summary["ticks"] == 8 and sum(summary["outcomes"].values()) >= t.offloaded


def test_fleet_runtime_profiler_phases(engines):
    """Under ``Obs`` a tick records ``repro``'s four profiler phases and a
    ``fleet.tick`` span, and the trace is the bare run's."""
    from repro_torch.obs import Obs

    _, eng, _ = engines
    feats = np.random.default_rng(5).normal(0, 1, (4, 16, 12)).astype(np.float32)
    obs = Obs()
    traced = simulate_fleet(eng, feats, n_shards=2, redistribute_every=1.0, obs=obs)
    report = obs.profiler.report()
    assert {"fleet.poll", "fleet.score", "fleet.decide_dispatch",
            "fleet.redistribute"} <= set(report)
    ticks = [e for e in obs.tracer.to_chrome()["traceEvents"] if e.get("name") == "fleet.tick"]
    assert len(ticks) == 4
    same_bits(traced, simulate_fleet(eng, feats, n_shards=2, redistribute_every=1.0))


def test_fleet_runtime_validates(engines):
    _, eng, _ = engines
    with pytest.raises(ValueError):
        FleetRuntime(eng, 2, n_shards=4)
    rt = FleetRuntime(eng, 8, n_shards=2)
    assert rt.plane.devices == [eng.device]
    with pytest.raises(ValueError):
        rt.step(np.zeros((4, 12), np.float32))
    with pytest.raises(ValueError):
        simulate_fleet(eng, np.zeros((8, 12), np.float32))


# ------------------------------------------------------- the city headline


@pytest.fixture(scope="module")
def city(tmp_path_factory):
    """``tests/test_fleet.py``'s headline scenario in both packages; the
    port's serves ``repro``'s fitted engine (its artifact)."""
    import dataclasses

    kw = dict(n_streams=256, n_ticks=32, calibration_frames=2048)
    jscn = jf.default_city_scenario(**kw)
    path = str(tmp_path_factory.mktemp("city") / "engine")
    jscn.engine.save(path)
    tscn = default_city_scenario(**kw, device="cpu")
    for f in ("features", "weak_ap", "strong_ap"):
        assert np.array_equal(getattr(tscn, f), getattr(jscn, f)), f
    assert tscn.hardness == jscn.hardness and tscn.seed == jscn.seed
    return jscn, dataclasses.replace(tscn, engine=OffloadEngine.load(path, device="cpu"))


@pytest.mark.parametrize("coordinated", [False, True], ids=["static", "coordinated"])
def test_city_arm_equals_repro(city, coordinated):
    jscn, tscn = city
    want = jf.run_city_scenario(jscn, coordinated=coordinated)
    got = run_city_scenario(tscn, coordinated=coordinated)
    same_fleet_trace(got.trace, want.trace)
    np.testing.assert_array_equal(got.effective, want.effective)
    np.testing.assert_array_equal(got.served, want.served)
    assert_close_tree(got.summary(), want.summary())


def test_city_coordinated_beats_static_equal_budget(city):
    """``tests/test_fleet.py``'s headline on the port: reward-driven
    redistribution beats the static equal split at equal realized spend."""
    _, tscn = city
    static = run_city_scenario(tscn, coordinated=False)
    coord = run_city_scenario(tscn, coordinated=True)
    assert abs(coord.realized_ratio() - static.realized_ratio()) <= 0.02
    assert coord.mean_effective() > static.mean_effective()
    assert coord.trace.telemetry.budget_redistributions >= 2
    shares = coord.trace.telemetry.shard_shares
    assert shares[-1] > 0.25 > shares[0]
    ratios = coord.trace.telemetry.shard_ratios
    assert ratios[-1] > ratios[0]
    assert static.trace.telemetry.shard_shares == (0.25,) * 4
    # the four-shard CPU plane serves the city bit for bit as one device
    same_bits(run_city_scenario(tscn, coordinated=True, plane=FleetPlane(CPU4)).trace,
              coord.trace)


# -------------------------------------------------------------- the plane


def synth(n_images, seed, num_classes=8, size=64.0):
    """``tests/test_sharding.py``'s detections and ground truth."""
    r = np.random.default_rng(seed)
    dets, gts = [], []
    for _ in range(n_images):
        m = int(r.integers(1, 6))
        b = r.uniform(0, size - 25, (m, 2))
        wh = r.uniform(5, 20, (m, 2))
        gts.append(GroundTruth(np.concatenate([b, b + wh], 1).astype(np.float32),
                               r.integers(0, num_classes, m).astype(np.int32)))
        k = int(r.integers(0, 12))
        b = r.uniform(0, size - 25, (k, 2))
        wh = r.uniform(5, 20, (k, 2))
        dets.append(Detections(np.concatenate([b, b + wh], 1).astype(np.float32),
                               r.uniform(0.1, 1.0, k).astype(np.float32),
                               r.integers(0, num_classes, k).astype(np.int32)))
    return dets, gts


@pytest.fixture(scope="module")
def plane():
    return FleetPlane(make_fleet_mesh(devices=CPU4))


def test_make_fleet_mesh():
    assert make_fleet_mesh(devices=CPU4) == [make_fleet_mesh(devices=["cpu"])[0]] * 4
    assert len(make_fleet_mesh(2, devices=CPU4)) == 2
    assert len(make_fleet_mesh(9, devices=CPU4)) == 4  # clamped to the devices there are
    with pytest.raises(ValueError):
        make_fleet_mesh(0, devices=CPU4)
    with pytest.raises(ValueError):
        make_fleet_mesh(devices=[])


def test_fleet_plane_shape(plane):
    assert plane.n_devices == 4
    assert plane.shard_sizes(13) == (4, 16) and plane.shard_sizes(250) == (63, 252)


def test_fleet_plane_single_device_falls_through():
    """One device: the plane returns the single-device functions' results."""
    one = FleetPlane(["cpu"])
    assert one.n_devices == 1
    dets, gts = synth(9, 0)
    db = DetectionsBatch.from_list(dets, device="cpu")
    gb = GroundTruthBatch.from_list(gts, device="cpu")
    ref, out = match_batch(db, gb), one.match(db, gb)
    np.testing.assert_array_equal(ref.tp, out.tp)
    np.testing.assert_array_equal(ref.match_gt, out.match_gt)
    np.testing.assert_array_equal(extract_features_batch(db, 5, 10, 64.0).numpy(),
                                  one.extract_features(db, 5, 10, 64.0))


def test_fleet_plane_match_refuses_tpu_tiling(plane):
    dets, gts = synth(4, 1)
    db = DetectionsBatch.from_list(dets, device="cpu")
    gb = GroundTruthBatch.from_list(gts, device="cpu")
    for kw in (dict(tile_b=8), dict(interpret=True), dict(tile_n=128, tile_m=128)):
        with pytest.raises(TypeError, match=sorted(kw)[0]):
            plane.match(db, gb, **kw)
    with pytest.raises(ValueError):
        plane.match(db, GroundTruthBatch.from_list(gts[:3], device="cpu"))


@pytest.mark.parametrize("B", [5, 7, 13, 150, 250])
def test_fleet_plane_match_and_features_bit_identical(plane, B):
    """Ragged against the 4-way split (5 = 2+2+1+0, 13 = 4+4+4+1, 150 =
    38*3+36)."""
    dets, gts = synth(B, seed=B)
    db = DetectionsBatch.from_list(dets, device="cpu")
    gb = GroundTruthBatch.from_list(gts, device="cpu")
    ref = match_batch(db, gb, (0.5, 0.75))
    out = plane.match(db, gb, (0.5, 0.75))
    assert np.array_equal(ref.tp, out.tp) and np.array_equal(ref.match_gt, out.match_gt)
    assert out.iou_thresholds == (0.5, 0.75)
    assert np.array_equal(extract_features_batch(db, 8, 25, 64.0).numpy(),
                          plane.extract_features(db, 8, 25, 64.0))


@pytest.fixture(scope="module")
def fused_engines():
    """Fused engines at F 32 / H 16 (``tests/test_sharding.py``'s) and at
    the deployable head, F 387 / H 128."""
    rng = np.random.default_rng(0)
    out = {}
    for F, H in ((32, 16), (387, 128)):
        x = rng.normal(0, 1, (256, F)).astype(np.float32)
        eng = OffloadEngine(reward_model=MLPRewardModel(
            config=EstimatorConfig(hidden=(H,), epochs=2, batch_size=64), device="cpu"))
        eng.fit(features=x, rewards=rng.normal(0, 1, 256))
        assert eng.reward_model.fused
        out[F] = (eng, x)
    return out


@pytest.mark.parametrize("F", [32, 387])
@pytest.mark.parametrize("B", [5, 7, 13, 150, 250, 256])  # 5: the last shard holds no row
def test_fleet_plane_score_bit_identical(plane, fused_engines, F, B):
    eng, x = fused_engines[F]
    before = kernel_stats.snapshot()
    out = plane.score(eng, x[:B])
    assert np.array_equal(np.asarray(eng.score(features=x[:B])), out)
    delta = kernel_stats.delta(before, kernel_stats.snapshot())
    assert delta["calls"]["fleet_plane.score"] == 1
    assert all(n == 0 for n in delta["launches"].values())  # the plain versions on the CPU


def test_fleet_plane_score_unfused_falls_through(plane):
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (64, 12)).astype(np.float32)
    eng = OffloadEngine(reward_model=MLPRewardModel(
        config=EstimatorConfig(hidden=(16, 8), epochs=1, batch_size=32), device="cpu"))
    eng.fit(features=x, rewards=rng.normal(0, 1, 64))
    assert not eng.reward_model.fused
    np.testing.assert_array_equal(plane.score(eng, x[:13]), eng.score(features=x[:13]))


@pytest.fixture(scope="module")
def detection_engine():
    dets_cal, _ = synth(120, seed=3)
    dcal = DetectionsBatch.from_list(dets_cal, device="cpu")
    fx = DetectionBoxFeatures(num_classes=8, top_k=25, image_size=64.0, device="cpu")
    eng = OffloadEngine(feature_extractor=fx, reward_model=MLPRewardModel(
        config=EstimatorConfig(hidden=(16,), epochs=2, batch_size=64), device="cpu"))
    eng.fit(features=extract_features_batch(dcal, 8, 25, 64.0),
            rewards=np.random.default_rng(1).uniform(0, 1, 120))
    assert eng.reward_model.fused
    return eng


@pytest.mark.parametrize("B", [5, 7, 13, 150, 250])
def test_fleet_plane_score_detections_bit_identical(plane, detection_engine, B):
    """The sharded ``score_pipeline`` route equals ``engine.score_device``
    bit for bit (the port's composed route agrees within 1e-5 only)."""
    dets, _ = synth(B, seed=100 + B)
    db = DetectionsBatch.from_list(dets, device="cpu")
    ref = detection_engine.score_device(db).numpy()
    assert np.array_equal(ref, plane.score_detections(detection_engine, db))
    np.testing.assert_allclose(detection_engine.score(db), ref, rtol=0, atol=EST_TOL)
