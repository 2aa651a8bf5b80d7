"""The port's streaming runtime against the JAX package's, on the CPU:
sessions over a frozen engine, edge workers, multi-edge dispatch and the
seeded end-to-end simulation, case by case after ``tests/test_runtime.py``.

``repro`` fits and saves each engine; the port serves the same artifact
(``OffloadEngine.load(device="cpu")``) on the same numpy features.  Steps,
offload flags, outcomes, edge names, latencies, clock times, telemetry
counts and dispatcher stats are held exactly (both packages draw jitter and
probe orders from the same seeded numpy generators); estimates at the MLP
tolerance, 1e-5."""
import numpy as np
import pytest
import torch

import repro.detection.batch  # noqa: F401  (first: repro's kernels import it back)
import repro.runtime as jrt
from repro.api import MLPRewardModel as JMLPRewardModel
from repro.api import OffloadEngine as JOffloadEngine
from repro.core import EstimatorConfig as JEstimatorConfig

import repro_torch.runtime as trt
from repro_torch.api import MLPRewardModel, OffloadEngine, list_feature_extractors, list_policies
from repro_torch.core.estimator import EstimatorConfig
from repro_torch.core.policy import TokenBucket
from repro_torch.runtime import (
    OUTCOME_DEGRADED,
    OUTCOME_DROPPED,
    OUTCOME_LOCAL,
    OUTCOME_OFFLOADED,
    EdgeLatencyModel,
    EdgeWorker,
    ManualClock,
    MultiEdgeDispatcher,
    OffloadRuntime,
    OffloadSession,
    default_edge_fleet,
    list_strategies,
    simulate,
)

EST_TOL = 1e-5  # tests/test_kernels.py's MLP tolerance


def synth(n=256, d=12, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    rewards = 2.0 * x[:, 0] + 0.3 * rng.normal(size=n)
    return x, rewards


def fit_pair(tmp_path_factory, policy="threshold", ratio=0.3, **policy_kwargs):
    """``repro`` fits and saves the engine; the port loads the artifact."""
    x, rewards = synth()
    jeng = JOffloadEngine(
        reward_model=JMLPRewardModel(
            config=JEstimatorConfig(hidden=(16,), epochs=15, batch_size=64)
        ),
        policy=policy,
        ratio=ratio,
        policy_kwargs=policy_kwargs,
    )
    jeng.fit(features=x, rewards=rewards)
    path = str(tmp_path_factory.mktemp(policy) / "engine")
    jeng.save(path)
    return jeng, OffloadEngine.load(path, device="cpu"), x


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    return fit_pair(tmp_path_factory)


@pytest.fixture(scope="module")
def bucket_engines(tmp_path_factory):
    return fit_pair(tmp_path_factory, policy="token_bucket", ratio=0.2, depth=4.0)


def same_decisions(got, want):
    assert [d.step for d in got] == [d.step for d in want]
    assert [d.offload for d in got] == [d.offload for d in want]
    np.testing.assert_allclose([d.estimate for d in got], [d.estimate for d in want],
                               atol=EST_TOL, rtol=0)


def same_telemetry(got, want, **kwargs):
    g, w = got.as_dict(**kwargs), want.as_dict(**kwargs)
    assert list(g) == list(w)
    assert g.pop("mean_estimate") == pytest.approx(w.pop("mean_estimate"), abs=EST_TOL)
    assert g == w


def same_trace(got, want):
    """Record for record: everything exact but the estimates (1e-5)."""
    assert len(got.records) == len(want.records)
    for g, w in zip(got.records, want.records):
        g, w = g.as_dict(), w.as_dict()
        assert g.pop("estimate") == pytest.approx(w.pop("estimate"), abs=EST_TOL)
        assert g == w
    assert got.dispatcher == want.dispatcher
    gs, ws = got.summary(), want.summary()
    same_telemetry(got.telemetry, want.telemetry)
    for key in ("steps", "outcomes", "dispatcher", "mean_offload_latency",
                "latency_decomposition", "effective_accuracy"):
        assert gs[key] == ws[key], key


# --------------------------------------------------------------- sessions


def test_session_matches_batch_decide(engines):
    """A threshold session is arrival-order invariant: per-item streaming
    decisions equal the engine's one-shot batch mask under any order, and
    the port's stream equals repro's."""
    jeng, eng, x = engines
    batch_mask = eng.decide(features=x[:64]).offload
    np.testing.assert_array_equal(batch_mask, jeng.decide(features=x[:64]).offload)
    for perm_seed in (0, 1):
        order = np.random.default_rng(perm_seed).permutation(64)
        decisions = OffloadSession(eng, micro_batch=8).submit_batch(features=x[:64][order])
        stream_mask = np.array([d.offload for d in decisions])
        np.testing.assert_array_equal(stream_mask, batch_mask[order])
        same_decisions(decisions, jrt.OffloadSession(jeng, micro_batch=8)
                       .submit_batch(features=x[:64][order]))


def test_session_micro_batch_size_invariance(engines):
    jeng, eng, x = engines
    masks = []
    for mb in (1, 7, 64):
        decisions = OffloadSession(eng, micro_batch=mb).submit_batch(features=x[:60])
        assert [d.step for d in decisions] == list(range(60))
        masks.append([d.offload for d in decisions])
        same_decisions(decisions, jrt.OffloadSession(jeng, micro_batch=mb)
                       .submit_batch(features=x[:60]))
    assert masks[0] == masks[1] == masks[2]


def test_token_bucket_session_order_dependent_but_rate_bound(bucket_engines):
    """token_bucket decisions depend on arrival order (the bucket is
    stateful) yet the hard rate constraint holds under every order; each
    order decides as repro's."""
    jeng, eng, x = bucket_engines
    masks = []
    for perm_seed in (0, 1, 2):
        order = np.random.default_rng(perm_seed).permutation(len(x))
        decisions = OffloadSession(eng, micro_batch=16).submit_batch(features=x[order])
        same_decisions(decisions, jrt.OffloadSession(jeng, micro_batch=16)
                       .submit_batch(features=x[order]))
        mask = np.array([d.offload for d in decisions])
        assert mask.mean() <= 0.2 + 4.0 / len(x) + 1e-9
        masks.append(mask)
    assert any(not np.array_equal(masks[0], m) for m in masks[1:])


def test_sessions_isolate_policy_state(tmp_path_factory):
    """Two sessions over one engine must not share bucket state."""
    jeng, eng, x = fit_pair(tmp_path_factory, policy="token_bucket", ratio=0.1, depth=2.0)
    a = OffloadSession(eng, micro_batch=4)
    b = OffloadSession(eng, micro_batch=4)
    da, db = a.submit_batch(features=x[:32]), b.submit_batch(features=x[:32])
    assert [d.offload for d in da] == [d.offload for d in db]
    assert eng.policy.bucket.level == eng.policy.depth  # engine untouched
    same_decisions(da, jrt.OffloadSession(jeng, micro_batch=4).submit_batch(features=x[:32]))


def test_midstream_set_ratio(engines):
    jeng, eng, x = engines
    sessions = [OffloadSession(eng, ratio=0.0, micro_batch=8),
                jrt.OffloadSession(jeng, ratio=0.0, micro_batch=8)]
    firsts = [s.submit_batch(features=x[:80]) for s in sessions]
    assert not any(d.offload for d in firsts[0])
    for s in sessions:
        s.set_ratio(1.0)
    assert sessions[0].telemetry.target_ratio == 1.0
    seconds = [s.submit_batch(features=x[80:160]) for s in sessions]
    assert all(d.offload for d in seconds[0])
    same_decisions(firsts[0] + seconds[0], firsts[1] + seconds[1])
    # the engine's own budget is untouched by session-local re-budgets
    assert eng.ratio == 0.3 and eng.policy.ratio == 0.3
    t = sessions[0].telemetry
    assert t.processed == 160 and t.offloaded == 80
    assert t.realized_ratio == pytest.approx(0.5)
    assert t.rolling_ratio == 1.0  # the 64-frame window saw only offloads
    same_telemetry(t, sessions[1].telemetry)


def test_session_telemetry_rewards(engines):
    jeng, eng, x = engines
    sessions = [OffloadSession(eng, micro_batch=4), jrt.OffloadSession(jeng, micro_batch=4)]
    for s in sessions:
        s.submit_batch(features=x[:8])
        for r in (0.5, -0.25):
            s.record_reward(r)
    t = sessions[0].telemetry
    assert t.rewards_recorded == 2 and t.reward_sum == pytest.approx(0.25)
    same_telemetry(t, sessions[1].telemetry)


def test_session_requires_fitted_engine():
    with pytest.raises(RuntimeError):
        OffloadSession(OffloadEngine(device="cpu"))


def test_session_telemetry_as_dict_byte_stable(engines):
    """The default ``as_dict`` payload keeps repro's keys; the video,
    online, fleet and mobility counters appear only behind their flags, with
    repro's values."""
    jeng, eng, x = engines
    sessions = [OffloadSession(eng, micro_batch=4), jrt.OffloadSession(jeng, micro_batch=4)]
    legacy_keys = [
        "processed", "offloaded", "realized_ratio", "rolling_ratio",
        "mean_estimate", "target_ratio", "pending", "reward_sum",
        "rewards_recorded",
    ]
    for s in sessions:
        s.submit_batch(features=x[:14], flush=False)
    assert list(sessions[0].telemetry.as_dict()) == legacy_keys
    assert sessions[0].telemetry.pending == 2
    before = sessions[0].telemetry.as_dict()
    for s in sessions:
        s.record_staleness(2.0)
        s.record_staleness(4.0)
        s.record_effective_accuracy(0.5)
        s.record_rtt(3.5)
        s.record_rtt(4.5)
        s.record_bandwidth(0.5)
        s.record_update()
        s.record_budget_share(0.4)
        s.record_redistribution()
        s.record_handover()
        s.record_coverage(-70.0)
    assert sessions[0].telemetry.as_dict() == before
    flags = ("include_video", "include_online", "include_fleet", "include_mobility")
    for flag in flags:
        same_telemetry(sessions[0].telemetry, sessions[1].telemetry, **{flag: True})
    full = sessions[0].telemetry.as_dict(**dict.fromkeys(flags, True))
    assert full["covered_frames"] == 2 and full["mean_staleness"] == pytest.approx(3.0)
    assert full["rtt_samples"] == 2 and full["mean_rtt"] == pytest.approx(4.0)
    assert full["budget_redistributions"] == 1 and full["handovers"] == 1


def test_session_carries_tracker_and_temporal_probes(engines):
    """``tracker=`` rides the session and temporal probes reach only the
    policies that declare them (threshold accepts none — no crash)."""
    _, eng, x = engines
    marker = object()
    session = OffloadSession(
        eng, micro_batch=1, tracker=marker,
        staleness=lambda: 1.0, scene_change=lambda: 0.0,
    )
    assert session.tracker is marker
    out = session.submit(features=x[0])
    assert len(out) == 1


def test_engine_save_load_resume_session(engines, tmp_path):
    """save -> load -> a session over the loaded engine continues the stream
    with decisions identical to the original artifact's (and repro's)."""
    jeng, eng, x = engines
    path = str(tmp_path / "engine")
    eng.save(path)
    loaded = OffloadEngine.load(path, device="cpu")
    s1, s2 = OffloadSession(eng, micro_batch=8), OffloadSession(loaded, micro_batch=8)
    sj = jrt.OffloadSession(JOffloadEngine.load(path), micro_batch=8)
    for lo, hi in ((0, 40), (40, 100), (100, 180)):
        d1 = s1.submit_batch(features=x[lo:hi])
        d2 = s2.submit_batch(features=x[lo:hi])
        assert [d.offload for d in d1] == [d.offload for d in d2]
        np.testing.assert_allclose(
            [d.estimate for d in d1], [d.estimate for d in d2], atol=1e-6
        )
        same_decisions(d1, sj.submit_batch(features=x[lo:hi]))
    assert s1.telemetry.as_dict() == s2.telemetry.as_dict()


def test_session_single_frames_and_submit_scored(engines):
    """``submit`` a frame at a time (numpy rows and tensor rows) and
    ``submit_scored`` decide as repro's; scored frames may not jump
    buffered ones."""
    jeng, eng, x = engines
    s, sj = OffloadSession(eng, micro_batch=5), jrt.OffloadSession(jeng, micro_batch=5)
    got, want = [], []
    for i in range(23):
        row = x[i] if i % 2 else torch.from_numpy(x[i])
        got += s.submit(features=row)
        want += sj.submit(features=x[i])
    assert s.telemetry.pending == sj.telemetry.pending == 3
    with pytest.raises(RuntimeError, match="flush"):
        s.submit_scored(np.zeros(2))
    got += s.flush()
    want += sj.flush()
    scored = np.linspace(0, 1, 7)
    got += s.submit_scored(torch.from_numpy(scored))
    want += sj.submit_scored(scored)
    same_decisions(got, want)
    assert [d.step for d in got] == list(range(30))
    with pytest.raises(ValueError, match="1-D"):
        s.submit(features=x[:2])


# ------------------------------------------------------- token-bucket clock


def test_token_bucket_injectable_clock_refill():
    clock = ManualClock()
    tb = TokenBucket(rate=1.0, depth=4.0, base_threshold=0.0, clock=clock)
    for _ in range(4):
        assert tb.try_take()
    assert not tb.try_take()
    assert not tb.decide(0.9)  # still frozen, still empty
    clock.advance(2.0)  # 2 time units -> 2 tokens
    assert tb.level < 1.0
    assert tb.decide(0.99)  # thresholded spend still works under the clock
    assert tb.level == pytest.approx(1.0)


def test_token_bucket_clock_determinism():
    def run(clock_cls, bucket_cls):
        clock = clock_cls()
        tb = bucket_cls(rate=0.5, depth=3.0, base_threshold=0.2, clock=clock)
        out = []
        for i in range(40):
            out.append(tb.decide(0.3 + 0.6 * ((i * 7) % 10) / 10))
            clock.advance(1.0)
        return out

    from repro.core.policy import TokenBucket as JTokenBucket

    mine = run(ManualClock, TokenBucket)
    assert mine == run(ManualClock, TokenBucket)
    assert mine == run(jrt.ManualClock, JTokenBucket)


def test_manual_clock_monotone():
    clock = ManualClock(5.0)
    assert clock() == 5.0
    clock.advance(1.5)
    assert clock() == 6.5
    with pytest.raises(ValueError):
        clock.advance(-1.0)


def test_manual_clock_rejects_nan():
    clock = ManualClock()
    with pytest.raises(ValueError):
        clock.advance(float("nan"))
    assert clock() == 0.0  # the failed advance left time untouched


def test_edge_latency_model_validates():
    for kw in (
        {"base": -1.0},
        {"per_inflight": -0.1},
        {"jitter": -0.5},
        {"base": float("nan")},
    ):
        with pytest.raises(ValueError):
            EdgeLatencyModel(**kw)
    assert EdgeLatencyModel(base=0.0).sample(0, np.random.default_rng(0)) == 0.0
    # the jitter draws are repro's
    m, jm = (cls(base=0.5, per_inflight=0.1, jitter=0.05)
             for cls in (EdgeLatencyModel, jrt.EdgeLatencyModel))
    r, jr = np.random.default_rng(3), np.random.default_rng(3)
    assert [m.sample(i, r) for i in range(8)] == [jm.sample(i, jr) for i in range(8)]


# ------------------------------------------------------------ edge workers


def test_edge_worker_capacity_and_completion():
    e = EdgeWorker("e0", capacity=2, latency=EdgeLatencyModel(base=1.0))
    assert e.try_admit(0.0, 0, 0.9) == pytest.approx(1.0)
    assert e.try_admit(0.0, 1, 0.9) == pytest.approx(1.0)
    assert e.try_admit(0.0, 2, 0.9) is None  # capacity full
    assert e.stats()["rejected"] == 1
    done = e.poll(1.0)
    assert sorted(j.step for j in done) == [0, 1]
    assert e.try_admit(1.0, 3, 0.9) is not None  # slots freed


def test_edge_worker_rate_limit_uses_sim_time():
    e = EdgeWorker(
        "e0", capacity=16, rate=1.0, burst=2.0, latency=EdgeLatencyModel(base=0.1)
    )
    assert e.try_admit(0.0, 0, 0.9) is not None
    assert e.try_admit(0.0, 1, 0.9) is not None
    assert e.try_admit(0.0, 2, 0.9) is None
    assert e.try_admit(2.0, 3, 0.9) is not None  # refilled by dt=2


def test_edge_worker_load_dependent_latency():
    e = EdgeWorker(
        "e0", capacity=4, latency=EdgeLatencyModel(base=1.0, per_inflight=0.5)
    )
    lat0 = e.try_admit(0.0, 0, 0.9)
    lat1 = e.try_admit(0.0, 1, 0.9)
    assert lat1 == pytest.approx(lat0 + 0.5)


@pytest.mark.parametrize("kwarg", ["link", "downlink"])
def test_edge_worker_links_wait_for_netsim(kwarg):
    """The netsim uplink / downlink (ported with ROADMAP queue A item 4)
    front the edge: an admission pays the link's queue and transit on top
    of service, as repro's does, and the two link fleets build."""
    import repro.netsim as jns
    import repro_torch.netsim as tns

    out = []
    for rt, ns in ((trt, tns), (jrt, jns)):
        e = rt.EdgeWorker("e0", capacity=4, latency=rt.EdgeLatencyModel(base=0.5),
                          **{kwarg: ns.ConstantRateLink(0.5)})
        lats = [e.try_admit(0.0, i, 0.5) for i in range(3)]
        out.append((lats, e.last_breakdown.as_dict(), e.predicted_uplink_delay(0.0),
                    e.uplink_state(0.0), e.stats()))
    assert out[0] == out[1]
    lats, bd, wait, state, stats = out[0]
    assert bd["transmit" if kwarg == "link" else "downlink"] > 0.0
    assert lats[2] == pytest.approx(sum(bd.values()))
    assert (wait > 0.0, state[0]) == ((True, 3) if kwarg == "link" else (False, 0))
    assert ("uplink" in stats) == (kwarg == "link")
    for fleet in (trt.default_congested_fleet, trt.default_linked_fleet):
        assert all(e.uplink is not None for e in fleet(3, seed=0))
    e = EdgeWorker("e0")
    assert e.predicted_uplink_delay(5.0) == 0.0 and e.uplink_state(5.0) == (0, 0)
    lat = e.try_admit(0.0, 0, 0.5)
    assert e.last_breakdown.as_dict() == {"queue": 0.0, "transmit": 0.0,
                                          "service": lat, "downlink": 0.0}


def test_edge_worker_matches_repro_step_for_step():
    """A seeded jittery, rate-limited edge admits, refuses, completes and
    cancels exactly as repro's."""
    kw = dict(capacity=3, rate=0.6, burst=2.0,
              latency=None, seed=5)
    mine = EdgeWorker("e", **dict(kw, latency=EdgeLatencyModel(0.8, 0.3, 0.4)))
    ref = jrt.EdgeWorker("e", **dict(kw, latency=jrt.EdgeLatencyModel(0.8, 0.3, 0.4)))
    out = []
    for e in (mine, ref):
        log = []
        for step in range(40):
            t = 0.35 * step
            log.append(e.try_admit(t, step, 0.5))
            if step == 20:
                log.append(e.cancel_steps({18, 19, 20}))
            log.append([(j.step, j.t_admit, j.t_done) for j in e.poll(t + 0.1)])
        out.append((log, e.stats()))
    assert out[0] == out[1]


# -------------------------------------------------------------- dispatcher


def tiny_fleet(capacity=1, rt=trt, **kw):
    return [
        rt.EdgeWorker(f"e{i}", capacity=capacity, latency=rt.EdgeLatencyModel(base=100.0), **kw)
        for i in range(2)
    ]


def test_dispatcher_validates_config():
    with pytest.raises(KeyError) as ei:
        MultiEdgeDispatcher(tiny_fleet(), "no_such_strategy")
    assert "round_robin" in str(ei.value)  # error enumerates the registry
    with pytest.raises(KeyError):
        MultiEdgeDispatcher(tiny_fleet(), on_saturation="explode")
    with pytest.raises(ValueError):
        MultiEdgeDispatcher([])
    with pytest.raises(ValueError):
        MultiEdgeDispatcher([EdgeWorker("same"), EdgeWorker("same")])
    assert list_strategies() == jrt.list_strategies() == [
        "round_robin", "least_loaded", "score_weighted"]


@pytest.mark.parametrize("on_saturation,outcome", [
    ("degrade", OUTCOME_DEGRADED), ("drop", OUTCOME_DROPPED),
])
def test_dispatcher_saturation_accounting(on_saturation, outcome):
    """Slow 1-slot edges: 2 admits, everything after is degraded/dropped,
    and the books balance exactly, as repro's."""
    disp = MultiEdgeDispatcher(tiny_fleet(), "least_loaded", on_saturation=on_saturation)
    ref = jrt.MultiEdgeDispatcher(tiny_fleet(rt=jrt), "least_loaded", on_saturation=on_saturation)
    results = [disp.dispatch(0.0, step, 0.9) for step in range(10)]
    want = [ref.dispatch(0.0, step, 0.9) for step in range(10)]
    assert [(r.edge, r.latency, r.outcome) for r in results] == \
        [(r.edge, r.latency, r.outcome) for r in want]
    offloaded = [r for r in results if r.outcome == OUTCOME_OFFLOADED]
    saturated = [r for r in results if r.outcome == outcome]
    assert len(offloaded) == 2 and len(saturated) == 8
    stats = disp.stats()
    assert stats == ref.stats()
    assert stats["dropped" if on_saturation == "drop" else "degraded"] == 8
    assert sum(e["accepted"] for e in stats["edges"].values()) == 2
    assert sum(e["rejected"] for e in stats["edges"].values()) == 16


def test_dispatcher_round_robin_spreads_evenly():
    edges = [
        EdgeWorker(f"e{i}", capacity=100, latency=EdgeLatencyModel(base=0.1))
        for i in range(3)
    ]
    disp = MultiEdgeDispatcher(edges, "round_robin")
    t = 0.0
    for step in range(30):
        disp.dispatch(t, step, 0.9)
        t += 1.0
    assert [e.accepted for e in edges] == [10, 10, 10]


def test_dispatcher_least_loaded_prefers_idle():
    slow = EdgeWorker("slow", capacity=4, latency=EdgeLatencyModel(base=1000.0))
    idle = EdgeWorker("idle", capacity=4, latency=EdgeLatencyModel(base=1000.0))
    disp = MultiEdgeDispatcher([slow, idle], "least_loaded")
    disp.dispatch(0.0, 0, 0.9)  # tie -> first edge
    r = disp.dispatch(0.0, 1, 0.9)
    assert r.edge == "idle"  # now slow has load, idle wins


def test_dispatcher_score_weighted_handles_saturated_edges():
    disp = MultiEdgeDispatcher(tiny_fleet(), "score_weighted", seed=0)
    results = [disp.dispatch(0.0, step, 0.9) for step in range(6)]
    assert sum(r.outcome == OUTCOME_OFFLOADED for r in results) == 2
    assert sum(r.outcome == OUTCOME_DEGRADED for r in results) == 4


def test_dispatcher_score_weighted_uses_estimate():
    """The estimate sharpens the probe-order weights; the seeded probe
    orders are repro's."""

    def orders(rt, estimate):
        edges = [
            rt.EdgeWorker("fast", capacity=3, latency=rt.EdgeLatencyModel(base=1.0)),
            rt.EdgeWorker("slow", capacity=1, latency=rt.EdgeLatencyModel(base=3.0)),
        ]
        disp = rt.MultiEdgeDispatcher(edges, "score_weighted", seed=123)
        return [disp._probe_order(estimate) for _ in range(400)]

    rate = {}
    for estimate in (0.0, 1.0):
        mine = orders(trt, estimate)
        assert mine == orders(jrt, estimate)
        rate[estimate] = sum(o[0] == 0 for o in mine) / 400
    assert rate[1.0] > rate[0.0]
    assert rate[1.0] > 0.85 and 0.6 < rate[0.0] < 0.95


def test_dispatcher_score_weighted_saturation_paths():
    edges = [
        EdgeWorker(f"e{i}", capacity=1, latency=EdgeLatencyModel(base=100.0))
        for i in range(3)
    ]
    disp = MultiEdgeDispatcher(edges, "score_weighted", seed=0)
    assert edges[1].try_admit(0.0, 0, 0.9) is not None
    order = disp._probe_order(0.9)
    assert order[-1] == 1 and sorted(order[:2]) == [0, 2]
    assert edges[0].try_admit(0.0, 1, 0.9) is not None
    assert edges[2].try_admit(0.0, 2, 0.9) is not None
    assert disp._probe_order(0.9) == [0, 1, 2]
    assert sorted(disp._probe_order(-3.7)) == [0, 1, 2]


def test_dispatcher_score_weighted_deterministic():
    def run(rt):
        edges = [
            rt.EdgeWorker(f"e{i}", capacity=3, latency=rt.EdgeLatencyModel(base=1.0 + i))
            for i in range(3)
        ]
        disp = rt.MultiEdgeDispatcher(edges, "score_weighted", seed=11)
        out = []
        t = 0.0
        for step in range(24):
            out.append(disp.dispatch(t, step, 0.9).edge)
            t += 0.5
        return out

    assert run(trt) == run(trt) == run(jrt)


def test_dispatcher_prefer_and_pin():
    def run(rt):
        edges = [rt.EdgeWorker(f"e{i}", capacity=1, latency=rt.EdgeLatencyModel(base=5.0))
                 for i in range(3)]
        disp = rt.MultiEdgeDispatcher(edges, "round_robin")
        out = [disp.dispatch(0.0, 0, 0.5, prefer=2).edge,
               disp.dispatch(0.0, 1, 0.5, prefer=2).edge,
               disp.dispatch(0.0, 2, 0.5, prefer=2, pin=True).outcome]
        with pytest.raises(ValueError):
            disp.dispatch(0.0, 3, 0.5, pin=True)
        with pytest.raises(IndexError):
            disp.dispatch(0.0, 3, 0.5, prefer=7)
        return out, disp.stats()

    assert run(trt) == run(jrt)
    # prefer probes e2 first, then the rotation (which moved on to e1)
    assert run(trt)[0] == ["e2", "e1", OUTCOME_DEGRADED]


# -------------------------------------------------------------- simulation


def test_simulate_trace_exactly_reproducible(engines):
    jeng, eng, x = engines

    def run(rt, e):
        return rt.simulate(
            e, features=x, n_edges=3, ratio=0.4, micro_batch=8,
            set_ratio_at={128: 0.1}, seed=7,
        )

    t1, t2 = run(trt, eng), run(trt, eng)
    assert t1.records == t2.records
    assert t1.summary() == t2.summary()
    same_trace(t1, run(jrt, jeng))


def test_simulate_end_to_end_multi_edge(engines):
    """The acceptance scenario: 1 weak device -> 3 heterogeneous edges;
    record for record repro's."""
    jeng, eng, x = engines
    trace = simulate(eng, features=x, n_edges=3, ratio=0.3, micro_batch=8, seed=0)
    same_trace(trace, jrt.simulate(jeng, features=x, n_edges=3, ratio=0.3, micro_batch=8,
                                   seed=0))
    assert len(trace.records) == len(x)
    assert [r.step for r in trace.records] == list(range(len(x)))
    counts = trace.outcome_counts()
    assert sum(counts.values()) == len(x)
    valid = {OUTCOME_LOCAL, OUTCOME_OFFLOADED, OUTCOME_DEGRADED, OUTCOME_DROPPED}
    assert set(counts) <= valid
    assert counts.get(OUTCOME_OFFLOADED, 0) > 0
    assert abs(trace.telemetry.realized_ratio - 0.3) < 0.07
    assert trace.offload_mask().mean() <= trace.telemetry.realized_ratio
    served = {n: 0 for n in trace.dispatcher["edges"]}
    for r in trace.records:
        if r.outcome == OUTCOME_OFFLOADED:
            served[r.edge] += 1
    for name, st in trace.dispatcher["edges"].items():
        assert st["accepted"] == served[name]
        assert st["completed"] == st["accepted"]
        assert st["inflight"] == 0
    assert [r.t_arrival for r in trace.records] == [float(i) for i in range(len(x))]


@pytest.mark.parametrize("strategy", ["round_robin", "score_weighted"])
def test_simulate_strategies_match_repro(engines, strategy):
    """The other two strategies under a tight fleet: probe orders, jitter and
    saturation outcomes record for record repro's."""
    jeng, eng, x = engines

    def fleet(rt):
        return [rt.EdgeWorker(f"e{i}", capacity=1 + i, rate=0.5, burst=1.0, seed=i,
                              latency=rt.EdgeLatencyModel(base=2.0, per_inflight=0.5, jitter=0.3))
                for i in range(2)]

    kw = dict(features=x, strategy=strategy, ratio=0.6, micro_batch=4, seed=3)
    trace = simulate(eng, edges=fleet(trt), **kw)
    same_trace(trace, jrt.simulate(jeng, edges=fleet(jrt), **kw))
    counts = trace.outcome_counts()
    assert counts[OUTCOME_DEGRADED] > 0 and counts[OUTCOME_OFFLOADED] > 0


def test_simulate_tensor_features_match_numpy(engines):
    """A device-style feature tensor streams row by row into the session's
    buffer; the trace equals the numpy stream's."""
    _, eng, x = engines
    kw = dict(n_edges=3, ratio=0.3, micro_batch=8, seed=0)
    a = simulate(eng, features=torch.from_numpy(x), **kw)
    b = simulate(eng, features=x, **kw)
    assert a.records == b.records and a.summary() == b.summary()


def test_simulate_mid_stream_rebudget(engines):
    jeng, eng, x = engines
    kw = dict(features=x, ratio=0.0, micro_batch=4, set_ratio_at={128: 1.0}, seed=0)
    trace = simulate(eng, **kw)
    first, second = trace.records[:128], trace.records[128:]
    assert not any(r.offload for r in first)
    assert all(r.offload for r in second)
    same_trace(trace, jrt.simulate(jeng, **kw))


def test_simulate_rebudget_not_retroactive(engines):
    jeng, eng, x = engines
    kw = dict(features=x[:32], ratio=1.0, micro_batch=8, set_ratio_at={13: 0.0}, seed=0)
    trace = simulate(eng, **kw)
    assert all(r.offload for r in trace.records[:13])
    assert not any(r.offload for r in trace.records[13:])
    same_trace(trace, jrt.simulate(jeng, **kw))


def test_edge_worker_tolerates_duplicate_step_ids():
    e = EdgeWorker("e0", capacity=4, latency=EdgeLatencyModel(base=1.0))
    assert e.try_admit(0.0, 0, 0.9) is not None
    assert e.try_admit(0.5, 0, 0.8) is not None  # same step, other session
    done = e.poll(2.0)
    assert [j.t_admit for j in sorted(done, key=lambda j: j.t_done)] == [0.0, 0.5]
    assert e.stats()["completed"] == 2 and e.stats()["inflight"] == 0


def test_engine_save_strips_policy_clock(tmp_path):
    """An injected clock is runtime wiring, not artifact state: saving a
    clocked token_bucket engine works and reloads clock-free, in both
    packages."""
    x, rewards = synth()
    eng = OffloadEngine(
        reward_model=MLPRewardModel(
            config=EstimatorConfig(hidden=(16,), epochs=3, batch_size=64), device="cpu"),
        policy="token_bucket", ratio=0.2,
        policy_kwargs=dict(depth=4.0, clock=ManualClock()), device="cpu",
    ).fit(features=x, rewards=rewards)
    path = str(tmp_path / "clocked")
    eng.save(path)
    for loaded in (OffloadEngine.load(path, device="cpu"), JOffloadEngine.load(path)):
        assert "clock" not in loaded.policy_kwargs
        assert loaded.policy.clock is None


def test_simulate_drop_mode_accounts_everything(engines):
    jeng, eng, x = engines
    traces = [
        rt.simulate(
            e, features=x[:64],
            edges=[rt.EdgeWorker("only", capacity=1, latency=rt.EdgeLatencyModel(base=1e6))],
            ratio=1.0, on_saturation="drop", micro_batch=8, seed=0,
        )
        for rt, e in ((trt, eng), (jrt, jeng))
    ]
    counts = traces[0].outcome_counts()
    assert counts[OUTCOME_OFFLOADED] == 1  # the single slot, never freed
    assert counts[OUTCOME_DROPPED] == 63
    assert traces[0].dispatcher["dropped"] == 63
    same_trace(*traces)


def test_runtime_sessions_share_frozen_engine(engines):
    _, eng, x = engines
    runtime = OffloadRuntime(eng, default_edge_fleet(3, seed=0))
    s1 = runtime.open_session(micro_batch=8)
    s2 = runtime.open_session(micro_batch=8)
    m1 = [d.offload for d in s1.submit_batch(features=x[:48])]
    m2 = [d.offload for d in s2.submit_batch(features=x[:48])]
    assert m1 == m2


def test_streaming_study_registry_helpers():
    assert "threshold" in list_policies() and "token_bucket" in list_policies()
    assert "detection_boxes" in list_feature_extractors()
    assert "lm_logits" in list_feature_extractors()


def test_default_edge_fleet_matches_repro():
    for n, seed in ((3, 0), (5, 2)):
        mine, ref = default_edge_fleet(n, seed), jrt.default_edge_fleet(n, seed)
        assert [(e.name, e.capacity, e.latency.base, e.latency.per_inflight,
                 e.latency.jitter, e._bucket.rate, e._bucket.depth) for e in mine] == \
            [(e.name, e.capacity, e.latency.base, e.latency.per_inflight,
              e.latency.jitter, e._bucket.rate, e._bucket.depth) for e in ref]
