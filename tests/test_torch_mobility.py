"""The port's mobility layer (``repro_torch.mobility``) against
``repro.mobility`` on the CPU, case by case after ``tests/test_mobility.py``.

The same seeds and numpy inputs go to both packages.  Tolerances:

* ``rollout`` (float32 tensor ops on the device) against ``rollout_ref``
  (numpy): the waypoint model exactly (the same float32 operations, the
  square root correctly rounded in both), the random walk within 1e-3,
  ``tests/test_mobility.py``'s own (its headings go through ``cos`` /
  ``sin``, whose float32 results differ by an ulp between libraries; 3.1e-5
  is the largest gap these cases show); against ``repro.mobility.rollout``
  (XLA's scan) within the same 1e-3;
* coverage, handover, ``apply_in_flight`` and the ``mobility_aware``
  policy: exact (copied numpy);
* ``MobileRuntime``: ``repro`` fits and saves the engine, the port loads the
  artifact (``OffloadEngine.load(device="cpu")``) and both serve ``repro``'s
  positions (``positions=``); records, handover logs and dispatcher stats
  are equal, estimates within 1e-5 (the MLP tolerance of
  ``tests/test_kernels.py``);
* the headline: ``tests/test_mobility.py``'s asserts on the port serving
  ``repro``'s engine.
"""
import dataclasses
import json

import numpy as np
import pytest

import repro.detection.batch  # noqa: F401  (first: repro's kernels import it back)
import repro.mobility as jm
from repro.api import MLPRewardModel as JMLPRewardModel
from repro.api import OffloadEngine as JOffloadEngine
from repro.api import make_policy as j_make_policy
from repro.core import EstimatorConfig as JEstimatorConfig
from repro.runtime import EdgeLatencyModel as JEdgeLatencyModel
from repro.runtime import EdgeWorker as JEdgeWorker

from repro_torch.api import OffloadEngine, list_policies, make_policy
from repro_torch.mobility import (
    BaseStation,
    CoverageMap,
    HandoverController,
    HandoverEvent,
    MobileRuntime,
    MotionConfig,
    PendingResult,
    apply_in_flight,
    default_mobile_scenario,
    default_stations,
    rollout,
    rollout_ref,
    run_mobile_scenario,
    station_fleet,
)
from repro_torch.obs import Obs
from repro_torch.runtime import EdgeLatencyModel, EdgeWorker, OffloadSession

EST_TOL = 1e-5  # tests/test_kernels.py's MLP tolerance
WALK_TOL = 1e-3  # tests/test_mobility.py's scan-vs-reference tolerance


def fitted_pair(tmp_path, ratio=0.5, policy=None, seed=0):
    """``tests/test_mobility.py``'s engine fitted by ``repro``, and the
    port's load of its artifact."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (256, 8)).astype(np.float32)
    rewards = 2.0 * x[:, 0] + 0.3 * rng.normal(size=256)
    jeng = JOffloadEngine(
        reward_model=JMLPRewardModel(
            config=JEstimatorConfig(hidden=(16,), epochs=10, batch_size=64)
        ),
        ratio=ratio,
    )
    jeng.fit(features=x, rewards=rewards)
    if policy is not None:
        jeng = jeng.with_policy(policy, ratio=ratio)
    path = str(tmp_path / "mobile_engine")
    jeng.save(path)
    return jeng, OffloadEngine.load(path, device="cpu")


def same_mobile_trace(got, want):
    """Two ``MobileTrace``s: records equal but the estimates (1e-5),
    positions, handovers, dispatcher stats and summaries equal."""
    assert np.array_equal(got.positions, want.positions)
    assert (got.mode, got.in_flight) == (want.mode, want.in_flight)
    assert len(got.records) == len(want.records)
    for g, w in zip(got.records, want.records):
        g, w = g.as_dict(), w.as_dict()
        assert abs(g.pop("estimate") - w.pop("estimate")) <= EST_TOL
        assert g == w
    assert [[e.as_dict() for e in h] for h in got.handovers] == \
        [[e.as_dict() for e in h] for h in want.handovers]
    assert got.dispatcher == want.dispatcher
    gs, ws = got.summary(), want.summary()
    for g, w in zip(gs.pop("telemetry"), ws.pop("telemetry")):
        assert g.pop("mean_estimate") == pytest.approx(w.pop("mean_estimate"), abs=EST_TOL)
        assert g == w
    assert gs == ws


# ------------------------------------------------------------------ motion


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("model", ["waypoint", "random_walk"])
def test_rollout_matches_reference(model, seed):
    cfg = MotionConfig(model=model, area=(800.0, 400.0), speed=9.0)
    got = rollout(cfg, 6, 50, seed=seed, device="cpu")
    ref = rollout_ref(cfg, 6, 50, seed=seed)
    assert got.shape == ref.shape == (50, 6, 2) and got.dtype == np.float32
    if model == "waypoint":
        assert np.array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=WALK_TOL)
    # the port's reference is repro's, and repro's scan is within 1e-3 of it
    assert np.array_equal(ref, jm.rollout_ref(cfg, 6, 50, seed=seed))
    np.testing.assert_allclose(got, jm.rollout(cfg, 6, 50, seed=seed), rtol=0, atol=WALK_TOL)
    assert got[..., 0].min() >= 0 and got[..., 0].max() <= 800.0
    assert got[..., 1].min() >= 0 and got[..., 1].max() <= 400.0


@pytest.mark.parametrize("model", ["waypoint", "random_walk"])
def test_rollout_bit_identical_under_seed(model):
    cfg = MotionConfig(model=model)
    a = rollout(cfg, 4, 64, seed=7, device="cpu")
    assert np.array_equal(a, rollout(cfg, 4, 64, seed=7, device="cpu"))
    assert not np.array_equal(a, rollout(cfg, 4, 64, seed=8, device="cpu"))


def test_motion_validation():
    with pytest.raises(KeyError):
        MotionConfig(model="teleport")
    with pytest.raises(ValueError):
        MotionConfig(dt=0.0)
    with pytest.raises(ValueError):
        rollout(MotionConfig(), 0, 10, device="cpu")
    assert MotionConfig(model="random_walk").spec() == \
        jm.MotionConfig(model="random_walk").spec()


# ---------------------------------------------------------------- coverage


def test_coverage_equals_repro():
    """Path loss, rate factors, the time to coverage loss and the station
    layout: exactly ``repro``'s."""
    d = np.array([[1.0, 0.0], [10.0, 0.0], [100.0, 0.0], [1000.0, 0.0]])
    st, jst = BaseStation("bs", x=0.0, y=0.0), jm.BaseStation("bs", x=0.0, y=0.0)
    rss = st.rss_dbm(d)
    assert np.array_equal(rss, jst.rss_dbm(d)) and np.all(np.diff(rss) < 0)
    cov = CoverageMap([st], floor_dbm=-80.0, full_dbm=-50.0)
    jcov = jm.CoverageMap([jst], floor_dbm=-80.0, full_dbm=-50.0)
    for dbm in (-40.0, -60.0, -65.0, -95.0):
        assert cov.rate_factor(dbm) == jcov.rate_factor(dbm)
    assert cov.rate_factor(-95.0) == cov.min_rate_factor
    trace = np.stack([np.linspace(1.0, 2000.0, 40), np.zeros(40)], axis=-1)
    cov2 = CoverageMap([st], floor_dbm=-70.0, full_dbm=-50.0)
    jcov2 = jm.CoverageMap([jst], floor_dbm=-70.0, full_dbm=-50.0)
    for t in (0, 10, 39):
        assert cov2.time_to_loss(trace, t, dt=1.0) == jcov2.time_to_loss(trace, t, dt=1.0)
    assert cov2.time_to_loss(np.ones((40, 2)), 0, dt=1.0) == float("inf")
    stations = default_stations(3, area=(1200.0, 600.0))
    assert [s.spec() for s in stations] == \
        [s.spec() for s in jm.default_stations(3, area=(1200.0, 600.0))]
    pos = np.random.default_rng(0).uniform(0, 1200, (50, 2))
    assert np.array_equal(CoverageMap(stations).rss(pos),
                          jm.CoverageMap(jm.default_stations(3, area=(1200.0, 600.0))).rss(pos))
    assert CoverageMap(stations).spec() == \
        jm.CoverageMap(jm.default_stations(3, area=(1200.0, 600.0))).spec()
    fleet = station_fleet(CoverageMap(stations), seed=3)
    jfleet = jm.station_fleet(jm.CoverageMap(jm.default_stations(3, area=(1200.0, 600.0))),
                              seed=3)
    assert [e.stats() for e in fleet] == [e.stats() for e in jfleet]


# ---------------------------------------------------------------- handover


def test_handover_controller_equals_repro():
    """A walk through the hysteresis band and the dwell: the same events."""
    ctrls = [cls(cov_cls(stations(2, area=(1000.0, 600.0))), hysteresis_db=3.0, min_dwell=5.0)
             for cls, cov_cls, stations in (
                 (HandoverController, CoverageMap, default_stations),
                 (jm.HandoverController, jm.CoverageMap, jm.default_stations))]
    steps = [(0.0, 260.0), (1.0, 510.0), (2.0, 700.0), (6.0, 700.0), (9.0, 300.0),
             (15.0, 200.0), (16.0, 820.0), (30.0, 820.0)]
    events = [[], []]
    for t, x in steps:
        for c, evs in zip(ctrls, events):
            ev = c.update(t, np.array([x, 300.0]))
            evs.append(None if ev is None else ev.as_dict())
    assert events[0] == events[1]
    assert ctrls[0].serving == ctrls[1].serving
    assert [e.as_dict() for e in ctrls[0].events] == [e.as_dict() for e in ctrls[1].events]
    ev = [e for e in events[0] if e is not None][0]
    assert (ev["source"], ev["target"]) == (0, 1) and ev["rss_target"] - ev["rss_source"] > 3.0


def test_apply_in_flight_semantics():
    def ledger():
        return [PendingResult(t_done=5.0, capture_step=3, step=30, edge=0),
                PendingResult(t_done=6.0, capture_step=4, step=41, edge=1)]

    ev = HandoverEvent(t=4.0, source=0, target=1, rss_source=-80, rss_target=-60)
    surv, n = apply_in_flight(ledger(), ev, "survive")
    assert n == 0 and len(surv) == 2
    edge = EdgeWorker("e", capacity=4, latency=EdgeLatencyModel(base=9.0, jitter=0.0), seed=0)
    jedge = JEdgeWorker("e", capacity=4, latency=JEdgeLatencyModel(base=9.0, jitter=0.0), seed=0)
    for e in (edge, jedge):
        e.try_admit(0.0, 30, 0.5)
    died, n = apply_in_flight(ledger(), ev, "die", edges=[edge, None])
    jev = jm.HandoverEvent(t=4.0, source=0, target=1, rss_source=-80, rss_target=-60)
    jledger = [jm.PendingResult(**dataclasses.asdict(p)) for p in ledger()]
    jdied, jn = jm.apply_in_flight(jledger, jev, "die", edges=[jedge, None])
    assert n == jn == 1 and [p.edge for p in died] == [p.edge for p in jdied] == [1]
    assert edge.stats() == jedge.stats() and edge.cancelled == 1 and edge.inflight == 0
    stale, n = apply_in_flight(ledger(), ev, "stale", stale_penalty=4)
    assert n == 1 and [p.capture_step for p in stale] == [3 - 4, 4]
    with pytest.raises(KeyError):
        apply_in_flight(ledger(), ev, "teleport")


# ------------------------------------------------------------------ policy


def test_mobility_aware_registered_and_equals_repro():
    assert "mobility_aware" in list_policies()
    cal = np.linspace(0.0, 1.0, 200)
    for kw in ({}, {"coverage_ttl": lambda: 0.0}, {"coverage_ttl": lambda: float("inf")},
               {"coverage_ttl": lambda: 3.0, "rtt_horizon": 4.0}):
        p, jp = make_policy("mobility_aware", cal, 0.5, **kw), \
            j_make_policy("mobility_aware", cal, 0.5, **kw)
        xs = np.random.default_rng(0).uniform(0, 1, 300)
        assert np.array_equal(p.decide_batch(xs), jp.decide_batch(xs))
        assert p.spec() == jp.spec()
    assert not make_policy("mobility_aware", cal, 0.5, coverage_ttl=lambda: 0.0).decide(0.99)
    with pytest.raises(ValueError):
        make_policy("mobility_aware", cal, 0.5, rtt_horizon=0.0)


def test_mobility_aware_budget_converges():
    rng = np.random.default_rng(0)
    cal = rng.uniform(0, 1, 500)
    est = rng.uniform(0, 1, 1000)
    ttls = np.r_[np.full(200, 0.5), np.full(800, np.inf)]
    decisions = []
    for mk in (make_policy, j_make_policy):
        it = iter(ttls)
        p = mk("mobility_aware", cal, 0.3, coverage_ttl=lambda: next(it))
        decisions.append([p.decide(float(e)) for e in est])
    assert decisions[0] == decisions[1]
    assert abs(np.mean(decisions[0]) - 0.3) < 0.05


def test_mobility_aware_artifact_strips_probe(tmp_path):
    _, eng = fitted_pair(tmp_path, ratio=0.4, policy="mobility_aware")
    clone = eng.with_policy("mobility_aware", ratio=0.4,
                            policy_kwargs={"rtt_horizon": 5.0, "coverage_ttl": lambda: 1.0})
    _, meta = clone.artifact_state()
    assert meta["policy"] == {"name": "mobility_aware", "kwargs": {"rtt_horizon": 5.0}}


def test_session_mobility_telemetry_gated(tmp_path):
    _, eng = fitted_pair(tmp_path, ratio=0.4)
    s = OffloadSession(eng, micro_batch=1)
    base_keys = set(s.telemetry.as_dict())
    s.record_handover()
    s.record_coverage(-70.0)
    s.record_coverage(-80.0)
    tel = s.telemetry
    assert set(tel.as_dict()) == base_keys
    d = tel.as_dict(include_mobility=True)
    assert d["handovers"] == 1 and d["coverage_samples"] == 2
    assert d["mean_coverage_dbm"] == pytest.approx(-75.0)


# ----------------------------------------------------------------- runtime


@pytest.fixture(scope="module")
def crossing_engines(tmp_path_factory):
    return fitted_pair(tmp_path_factory.mktemp("crossing"), ratio=0.9)


def _crossing(pkg, in_flight, engine):
    """``tests/test_mobility.py``'s one client walking through a 2-cell
    corridor with slow edge service, in package ``pkg``."""
    cov_cls, stations, fleet_fn, lat, rt_cls, mc = (
        (jm.CoverageMap, jm.default_stations, jm.station_fleet, JEdgeLatencyModel,
         jm.MobileRuntime, jm.MotionConfig) if pkg == "repro" else
        (CoverageMap, default_stations, station_fleet, EdgeLatencyModel, MobileRuntime,
         MotionConfig))
    cov = cov_cls(stations(2, area=(1000.0, 600.0)))
    fleet = fleet_fn(cov, capacity=16, service=lat(base=6.0, per_inflight=0.0, jitter=0.0),
                     transmit_time=0.05, downlink_time=0.02, seed=0)
    rt = rt_cls(engine, cov, fleet, motion=mc(area=(1000.0, 600.0), speed=12.0),
                mode="handover", in_flight=in_flight, hysteresis_db=2.0, min_dwell=4.0,
                stale_penalty=5, stale_horizon=24, seed=0)
    T = 70
    x = np.linspace(60.0, 940.0, T, dtype=np.float32)
    pos = np.stack([x, np.full(T, 300.0, np.float32)], axis=-1)[:, None, :]
    feats = np.random.default_rng(3).normal(0, 1, (T, 1, 8)).astype(np.float32)
    return rt.serve(feats, np.full((T, 1), 0.3), np.full((T, 1), 0.9), ratio=0.9, positions=pos)


@pytest.mark.parametrize("in_flight", ["survive", "die", "stale"])
def test_in_flight_semantics_equal_repro(crossing_engines, in_flight):
    jeng, eng = crossing_engines
    got = _crossing("port", in_flight, eng)
    same_mobile_trace(got, _crossing("repro", in_flight, jeng))
    assert got.n_handovers() >= 1
    again = _crossing("port", in_flight, eng)
    assert [r.as_dict() for r in again.records] == [r.as_dict() for r in got.records]


def test_in_flight_semantics_on_seeded_trace(crossing_engines):
    _, eng = crossing_engines
    surv, die, stale = (_crossing("port", m, eng) for m in ("survive", "die", "stale"))
    cancelled = sum(e.get("cancelled", 0) for e in die.dispatcher["edges"].values())
    assert cancelled >= 1
    assert sum(e.get("cancelled", 0) for e in surv.dispatcher["edges"].values()) == 0
    assert die.telemetry[0].covered_frames < surv.telemetry[0].covered_frames
    assert stale.telemetry[0].mean_staleness > surv.telemetry[0].mean_staleness
    assert surv.mean_effective_accuracy() >= die.mean_effective_accuracy()


# ---------------------------------------------------------------- headline


@pytest.fixture(scope="module")
def scenarios(tmp_path_factory):
    """``tests/test_mobility.py``'s scenario in both packages; the port's
    serves ``repro``'s fitted engine (its artifact)."""
    jscn = jm.default_mobile_scenario(n_clients=4, n_steps=120, seed=0)
    path = str(tmp_path_factory.mktemp("mobile") / "engine")
    jscn.engine.save(path)
    tscn = default_mobile_scenario(n_clients=4, n_steps=120, seed=0, device="cpu")
    for f in ("features", "weak_acc", "strong_acc"):
        assert np.array_equal(getattr(tscn, f), getattr(jscn, f)), f
    assert tscn.motion.spec() == jscn.motion.spec()
    assert tscn.coverage.spec() == jscn.coverage.spec()
    return jscn, dataclasses.replace(tscn, engine=OffloadEngine.load(path, device="cpu"))


def _serve_on(scn, mode, positions, runtime_cls, in_flight="survive"):
    """``run_mobile_scenario`` with the positions given."""
    rt = runtime_cls(scn.engine, scn.coverage, scn.fleet(), motion=scn.motion, mode=mode,
                     in_flight=in_flight, seed=scn.seed)
    return rt.serve(scn.features, scn.weak_acc, scn.strong_acc, positions=positions)


@pytest.mark.parametrize("mode,in_flight", [("handover", "survive"), ("handover", "die"),
                                            ("handover", "stale"), ("static", "survive")])
def test_mobile_runtime_equals_repro(scenarios, mode, in_flight):
    """On ``repro``'s engine and ``repro``'s positions, the port's trace is
    ``repro``'s."""
    jscn, tscn = scenarios
    want = jm.run_mobile_scenario(jscn, mode, in_flight=in_flight)
    same_mobile_trace(_serve_on(tscn, mode, want.positions, MobileRuntime, in_flight), want)


def test_headline_handover_beats_static_pinning(scenarios):
    _, tscn = scenarios
    handover = run_mobile_scenario(tscn, "handover")
    static = run_mobile_scenario(tscn, "static")
    assert handover.realized_ratio() == pytest.approx(static.realized_ratio(), abs=1e-12)
    assert handover.mean_effective_accuracy() > static.mean_effective_accuracy()
    assert handover.n_handovers() >= 1 and static.n_handovers() == 0
    assert np.array_equal(handover.positions, static.positions)
    # the port rolled the positions out itself: the waypoint reference's, exactly
    assert np.array_equal(handover.positions, rollout_ref(tscn.motion, 4, 120, tscn.seed))


def test_headline_trace_deterministic(scenarios):
    _, tscn = scenarios
    a = run_mobile_scenario(tscn, "handover")
    b = run_mobile_scenario(tscn, "handover")
    assert np.array_equal(a.positions, b.positions)
    assert [r.as_dict() for r in a.records] == [r.as_dict() for r in b.records]
    assert [[e.as_dict() for e in evs] for evs in a.handovers] == \
        [[e.as_dict() for e in evs] for evs in b.handovers]


def test_mobility_obs_spans_and_series(scenarios):
    _, tscn = scenarios
    obs = Obs()
    tr = run_mobile_scenario(tscn, "handover", obs=obs)
    assert tr.n_handovers() >= 1
    text = obs.metrics.to_prometheus()
    for series in ("repro_handovers_total", "repro_coverage_dbm", "repro_coverage_samples_total"):
        assert series in text, series
    assert 'stream="client0"' in text
    evs = json.loads(json.dumps(obs.tracer.to_chrome()))["traceEvents"]
    offloads = {e["id"]: e["ts"] for e in evs if e["name"] == "offload" and e["ph"] == "b"}
    ends = {e["id"]: e["ts"] for e in evs if e["name"] == "offload" and e["ph"] == "e"}
    downlinks = [e for e in evs if e["name"] == "downlink" and e["ph"] == "b"]
    assert offloads and downlinks
    for d in downlinks:
        assert offloads[d["id"]] <= d["ts"] <= ends[d["id"]]
    bare = run_mobile_scenario(tscn, "handover")
    assert [r.as_dict() for r in bare.records] == [r.as_dict() for r in tr.records]


def test_mobile_trace_summary_shape(scenarios):
    _, tscn = scenarios
    s = run_mobile_scenario(tscn, "handover").summary()
    assert s["mode"] == "handover" and s["clients"] == 4
    assert 0.0 < s["mean_effective_accuracy"] < 1.0
    assert len(s["telemetry"]) == 4
    for tel in s["telemetry"]:
        assert "handovers" in tel and "mean_coverage_dbm" in tel
    st = run_mobile_scenario(tscn, "static")
    assert all(t["coverage_samples"] > 0 for t in st.summary()["telemetry"])
