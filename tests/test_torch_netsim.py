"""The port's network simulator against the JAX package's, on the CPU: the
seeded links and queues (exactly ``repro``'s), the value-iteration solve
(within 1e-5 of ``repro``'s jitted scan and 1e-4 of the Python oracle, the
tolerance of tests/test_netsim.py), both queue-aware policies, the
link-fronted ``EdgeWorker`` and the two linked fleets, and seeded
``simulate`` runs over them: record for record ``repro``'s, the latency
breakdown parts at 1e-9 and the estimates at 1e-5.

``repro`` fits and saves each engine; the port serves the same artifact
(``OffloadEngine.load(device="cpu")``)."""
import dataclasses
import importlib

import numpy as np
import pytest

import repro.detection.batch  # noqa: F401  (first: repro's kernels import it back)
import repro.netsim as jns
import repro.runtime as jrt
from repro.api import MLPRewardModel as JMLPRewardModel
from repro.api import OffloadEngine as JOffloadEngine
from repro.api import make_policy as j_make_policy
from repro.core import EstimatorConfig as JEstimatorConfig

# the module itself: repro.runtime's `simulate` is the function, and it does
# not re-export default_linked_fleet
jsim = importlib.import_module("repro.runtime.simulate")

import repro_torch.netsim as tns
import repro_torch.runtime as trt
from repro_torch.api import OffloadEngine, list_policies, make_policy, policy_context_params
from repro_torch.netsim.policy import _estimate_bins
from repro_torch.runtime import OUTCOME_OFFLOADED, OffloadSession

EST_TOL = 1e-5  # tests/test_kernels.py's MLP tolerance
VI_TOL = 1e-5  # float32 sweeps, two summation orders
REF_TOL = 1e-4  # tests/test_netsim.py: the jitted scan against the Python oracle
BREAKDOWN_TOL = 1e-9


# ------------------------------------------------------------------- links


def _links(ns):
    return [
        ns.ConstantRateLink(2.0, propagation=0.5),
        ns.TraceBandwidthLink([0.0, 3.0, 7.5], [1.0, 0.25, 4.0], propagation=0.1),
        ns.GilbertElliottLink(1.0),
        ns.GilbertElliottLink(0.2, bad_bandwidth=0.05, p_gb=0.3, p_bg=0.2, slot=0.5,
                              propagation=0.2, seed=11),
    ]


@pytest.mark.parametrize("i", range(4))
def test_links_equal_repro(i):
    """Rates, channel states and delays at every probe — the future first,
    then the past — and the spec, exactly repro's."""
    mine, ref = _links(tns)[i], _links(jns)[i]
    times = [40.0, 0.0, 0.49, 0.5, 2.999, 3.0, 7.5, 12.25, 39.9, 1.0]
    for link in (mine, ref):
        link.log = [(link.bandwidth_at(t), link.state_at(t), link.transmit_delay(3.0, t))
                    for t in times]
    assert mine.log == ref.log
    assert mine.spec() == ref.spec()
    if i >= 2:
        assert mine.stationary_bad_fraction() == ref.stationary_bad_fraction()
        assert len(set(s for _, s, _ in mine.log)) == 2


@pytest.mark.parametrize("make", [
    lambda ns: ns.NetworkLink(0.0),
    lambda ns: ns.NetworkLink(1.0, propagation=-1.0),
    lambda ns: ns.ConstantRateLink(1.0).transmit_delay(-1.0, 0.0),
    lambda ns: ns.TraceBandwidthLink([1.0, 0.0], [1.0, 1.0]),
    lambda ns: ns.TraceBandwidthLink([0.0], [1.0, 2.0]),
    lambda ns: ns.TraceBandwidthLink([0.0, 1.0], [1.0, 0.0]),
    lambda ns: ns.GilbertElliottLink(1.0, p_gb=1.5),
    lambda ns: ns.GilbertElliottLink(1.0, slot=0.0),
    lambda ns: ns.GilbertElliottLink(1.0, bad_bandwidth=-1.0),
    lambda ns: ns.GilbertElliottLink(1.0, max_slots=4).state_at(10.0),
])
def test_link_validation_equals_repro(make):
    with pytest.raises(ValueError) as mine:
        make(tns)
    with pytest.raises(ValueError) as ref:
        make(jns)
    assert str(mine.value) == str(ref.value)


# ------------------------------------------------------------------ queues


def _queue_run(ns, seed, downlink=False):
    """A seeded random link, depth and arrival pattern; the log of every
    call's result."""
    rng = np.random.default_rng(seed)
    kind = rng.integers(0, 3)
    if kind == 0:
        link = ns.ConstantRateLink(float(rng.uniform(0.2, 3.0)))
    elif kind == 1:
        times = np.cumsum(rng.uniform(0.5, 3.0, 4)) - 0.5
        link = ns.TraceBandwidthLink(times, rng.uniform(0.2, 3.0, 4))
    else:
        link = ns.GilbertElliottLink(float(rng.uniform(0.5, 3.0)), p_gb=0.2, p_bg=0.3,
                                     seed=int(seed))
    cls = ns.DownlinkQueue if downlink else ns.UplinkQueue
    q = cls(link, depth=int(rng.integers(1, 6)))
    log, t = [], 0.0
    for i in range(int(rng.integers(10, 40))):
        t += float(rng.uniform(0.0, 1.5))
        size = float(rng.uniform(0.1, 4.0)) if i % 3 else None
        log.append((q.predicted_wait(t), q.predicted_sojourn(t, size), q.full(t)))
        f = q.enqueue(t, i, size)
        log.append(None if f is None else (dataclasses.astuple(f), f.queue_delay,
                                           f.transmit_delay, f.sojourn))
        if i % 5 == 4:
            log.append([dataclasses.astuple(d) for d in q.poll(t + 0.7)])
        log.append((q.occupancy, q.stats()))
    log.append([dataclasses.astuple(d) for d in q.poll(1e12)])
    log.append(q.stats())
    return log


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("downlink", [False, True])
def test_queues_equal_repro(seed, downlink):
    mine, ref = _queue_run(tns, seed, downlink), _queue_run(jns, seed, downlink)
    assert mine == ref
    st = mine[-1]
    assert st["delivered"] + st["dropped"] == st["enqueued"] + st["dropped"]
    assert st["occupancy"] == 0


def test_uplink_queue_fifo_schedule_exact():
    q = tns.UplinkQueue(tns.ConstantRateLink(1.0), depth=8, frame_bits=2.0)
    f0, f1, f2 = q.enqueue(0.0, 0), q.enqueue(0.5, 1), q.enqueue(5.0, 2)
    assert (f0.t_start, f0.t_delivered) == (0.0, 2.0)
    assert (f1.t_start, f1.t_delivered) == (2.0, 4.0)
    assert (f2.t_start, f2.t_delivered) == (5.0, 7.0)
    assert q.delivered == [f0, f1] and q.poll(100.0) == [f2]
    assert tns.DownlinkQueue(tns.ConstantRateLink(1.0)).stats() == \
        jns.DownlinkQueue(jns.ConstantRateLink(1.0)).stats()


# --------------------------------------------------------- value iteration


@pytest.mark.parametrize("lam,kw", [
    (0.4, dict(max_queue=8, n_sweeps=40)),
    (0.0, dict()),
    (0.8, dict(max_queue=12, delay_cost=0.03, bad_slowdown=2.0, p_gb=0.2, p_bg=0.1,
               gamma=0.95, n_sweeps=80)),
    (1e9, dict(max_queue=4, n_sweeps=8)),  # the ratio-0 sentinel price
])
def test_solve_value_iteration_equals_repro_and_ref(lam, kw):
    e = np.quantile(np.random.default_rng(2).beta(2, 5, 500), (np.arange(32) + 0.5) / 32)
    V, theta = tns.solve_value_iteration(e, lam, device="cpu", **kw)
    jV, jtheta = jns.solve_value_iteration(e, lam, **kw)
    rV, rtheta = tns.value_iteration_ref(e, lam, **kw)
    Q = kw.get("max_queue", 16)
    assert V.shape == theta.shape == (Q + 1, 2) and V.dtype == theta.dtype == np.float64
    scale = max(1.0, abs(lam))  # the sentinel price is held relative to its size
    np.testing.assert_allclose(V, jV, atol=VI_TOL * scale)
    np.testing.assert_allclose(theta, jtheta, atol=VI_TOL * scale)
    np.testing.assert_allclose(V, rV, atol=REF_TOL * scale)
    np.testing.assert_allclose(theta, rtheta, atol=REF_TOL * scale)
    assert tns.value_iteration_ref(e, lam, **kw)[1].tolist() == \
        jns.value_iteration_ref(e, lam, **kw)[1].tolist()


def test_value_iteration_sweep_equals_repro():
    cal = np.random.default_rng(5).uniform(0, 1, 400)
    ratios = [0.0, 0.1, 0.3, 0.6, 1.0]
    got = tns.value_iteration_sweep(cal, ratios, max_queue=8, n_sweeps=40, device="cpu")
    want = jns.value_iteration_sweep(cal, ratios, max_queue=8, n_sweeps=40)
    assert got.shape == want.shape == (5, 9, 2)
    np.testing.assert_allclose(got, want, atol=VI_TOL, rtol=VI_TOL)
    bins = _estimate_bins(cal, 32)
    for i, r in enumerate(ratios[1:-1], 1):
        lam = tns.quantile_threshold(cal, r)
        np.testing.assert_allclose(got[i], tns.value_iteration_ref(bins, lam, max_queue=8,
                                                                   n_sweeps=40)[1],
                                   atol=REF_TOL)
        np.testing.assert_allclose(got[i], tns.solve_value_iteration(
            bins, lam, max_queue=8, n_sweeps=40, device="cpu")[1], atol=VI_TOL)
    assert np.all(got[3] < got[1])  # more budget -> lower thresholds
    assert np.all(np.diff(got[2][:-1, tns.CHANNEL_GOOD]) > 0)
    assert np.all(got[2][:, tns.CHANNEL_BAD] >= got[2][:, tns.CHANNEL_GOOD])
    np.testing.assert_array_equal(_estimate_bins(cal, 32),
                                  jns.policy._estimate_bins(cal, 32))


def test_value_iteration_sweep_rejects_unknown_kwargs():
    with pytest.raises(TypeError):
        tns.value_iteration_sweep(np.linspace(0, 1, 16), [0.3], delay_costs=0.2, device="cpu")


# ---------------------------------------------------------------- policies


def test_netsim_policies_registered():
    names = list_policies()
    assert "queue_aware" in names and "value_iteration" in names
    assert policy_context_params("queue_aware") == ("congestion",)
    assert policy_context_params("value_iteration") == ("state_probe", "device")


@pytest.mark.parametrize("kw", [dict(), dict(delay_weight=0.8, delay_scale=0.5, gain=0.2)])
def test_queue_aware_decisions_equal_repro(kw):
    rng = np.random.default_rng(4)
    cal, est = rng.uniform(0, 1, 300), rng.uniform(0, 1, 400)
    delays = np.abs(rng.normal(0, 3, 400))
    out = []
    for mk in (make_policy, j_make_policy):
        p = mk("queue_aware", cal, 0.3, congestion=lambda it=iter(delays): next(it), **kw)
        first = p.decide_batch(est[:250])
        p.set_ratio(0.6)
        out.append((first.tolist(), p.decide_batch(est[250:]).tolist(), p.spec(), p.gain))
    assert out[0] == out[1]
    assert 0 < sum(out[0][0]) < 250
    for ratio, want in ((0.0, False), (1.0, True)):  # degenerate budgets stay hard
        p = make_policy("queue_aware", cal, ratio, congestion=lambda: 100.0)
        assert p.decide(0.99 if not want else -1.0) is want
    with pytest.raises(ValueError):
        make_policy("queue_aware", cal, 0.3, delay_scale=0.0)


def test_value_iteration_policy_equals_repro():
    rng = np.random.default_rng(6)
    cal, est = rng.uniform(0, 1, 400), rng.uniform(0, 1, 300)
    states = [(int(q), int(c)) for q, c in zip(rng.integers(-2, 12, 300), rng.integers(0, 2, 300))]
    kw = dict(max_queue=8, n_sweeps=40)
    pols = []
    for mk, extra in ((make_policy, dict(device="cpu")), (j_make_policy, {})):
        pols.append(mk("value_iteration", cal, 0.4,
                       state_probe=lambda it=iter(states): next(it), **kw, **extra))
    mine, ref = pols
    np.testing.assert_allclose(mine.theta, ref.theta, atol=VI_TOL)
    assert mine.spec() == ref.spec()
    got, want = mine.decide_batch(est), ref.decide_batch(est)
    qc = [(min(max(q, 0), 8), c) for q, c in states]
    near = np.array([abs(e - ref.theta[s]) <= VI_TOL for e, s in zip(est, qc)])
    np.testing.assert_array_equal(got[~near], want[~near])
    mine.set_ratio(1.0)
    mine.state_probe = lambda: (8, 1)
    assert mine.decide(-1.0)  # always-offload budget wins in any state
    assert make_policy("value_iteration", cal, 0.4, device="cpu").decide(0.99)  # no probe: (0, good)


# -------------------------------------------------- EdgeWorker link front-end


def _edge(rt, ns, case):
    lat = rt.EdgeLatencyModel(base=0.5, per_inflight=0.1, jitter=0.2)
    if case == "uplink":
        return rt.EdgeWorker("e", capacity=6, latency=lat, link=ns.ConstantRateLink(0.5),
                             queue_depth=3, frame_bits=1.0, seed=2)
    if case == "fading_rate":
        return rt.EdgeWorker("e", capacity=8, rate=0.6, burst=2.0, latency=lat,
                             link=ns.GilbertElliottLink(0.8, seed=3), queue_depth=4, seed=5)
    return rt.EdgeWorker("e", capacity=8, latency=lat, link=ns.ConstantRateLink(1.0),
                         queue_depth=5, downlink=ns.TraceBandwidthLink([0.0, 6.0], [2.0, 0.2]),
                         downlink_depth=2, result_bits=0.5, seed=7)


@pytest.mark.parametrize("case", ["uplink", "fading_rate", "uplink_downlink"])
def test_edge_worker_link_matches_repro_step_for_step(case):
    out = []
    for rt, ns in ((trt, tns), (jrt, jns)):
        e, log = _edge(rt, ns, case), []
        for step in range(40):
            t = 0.45 * step
            log.append((e.predicted_uplink_delay(t), e.uplink_state(t), e.expected_latency()))
            lat = e.try_admit(t, step, 0.5, 1.5 if step % 4 == 0 else None)
            log.append((lat, e.last_breakdown.as_dict() if lat is not None else None))
            if step == 20:
                log.append(e.cancel_steps({18, 19, 20}))
            log.append([(j.step, j.t_admit, j.t_done) for j in e.poll(t + 0.1)])
        out.append((log, e.stats()))
    assert out[0] == out[1]
    log, stats = out[0]
    assert "uplink" in stats and ("downlink" in stats) == (case == "uplink_downlink")
    admitted = [e[1] for e in log if isinstance(e, tuple) and len(e) == 2 and e[1] is not None]
    assert admitted and all(bd["transmit"] > 0 for bd in admitted)
    assert any(bd["queue"] > 0 for bd in admitted)
    assert stats["rejected"] > 0


def test_edge_worker_full_uplink_does_not_burn_rate_token():
    e = trt.EdgeWorker("e0", capacity=100, rate=0.0, burst=2.0,
                       latency=trt.EdgeLatencyModel(base=0.1),
                       link=tns.ConstantRateLink(0.5), queue_depth=1)
    assert e.try_admit(0.0, 0, 0.9) is not None
    assert e.try_admit(0.0, 1, 0.9) is None  # queue full: no token spent
    assert e.try_admit(3.0, 2, 0.9) is not None
    assert e.try_admit(6.0, 3, 0.9) is None


# ------------------------------------------------------------------ fleets


def _fleet_spec(fleet):
    return [(e.name, e.capacity, e.latency, e._bucket.rate if e._bucket else None,
             e._bucket.depth if e._bucket else None, type(e.uplink.link).__name__,
             e.uplink.link.spec(), e.uplink.depth, e.uplink.frame_bits, e.downlink)
            for e in fleet]


@pytest.mark.parametrize("name,kw", [
    ("default_congested_fleet", dict(n=3, seed=0)),
    ("default_congested_fleet", dict(n=2, seed=5, queue_depth=6, bad_slowdown=2.0)),
    ("default_linked_fleet", dict(n=3, seed=0)),
    ("default_linked_fleet", dict(n=4, seed=2, fading=True)),
])
def test_fleets_match_repro(name, kw):
    mine, ref = getattr(trt, name)(**kw), getattr(jsim, name)(**kw)
    strip = [s[:2] + (dataclasses.astuple(s[2]),) + s[3:] for s in _fleet_spec(ref)]
    assert [s[:2] + (dataclasses.astuple(s[2]),) + s[3:] for s in _fleet_spec(mine)] == strip


# ------------------------------------------------------------- simulation


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """repro fits and saves; the port loads the artifact on the CPU."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (256, 12)).astype(np.float32)
    rewards = 2.0 * x[:, 0] + 0.3 * rng.normal(size=256)
    jeng = JOffloadEngine(
        reward_model=JMLPRewardModel(config=JEstimatorConfig(hidden=(16,), epochs=15,
                                                             batch_size=64)),
        ratio=0.35,
    )
    jeng.fit(features=x, rewards=rewards)
    path = str(tmp_path_factory.mktemp("netsim") / "engine")
    jeng.save(path)
    return jeng, OffloadEngine.load(path, device="cpu"), x


def same_trace(got, want):
    assert len(got.records) == len(want.records)
    for g, w in zip(got.records, want.records):
        g, w = g.as_dict(), w.as_dict()
        assert g.pop("estimate") == pytest.approx(w.pop("estimate"), abs=EST_TOL)
        for part in ("latency", "queue_delay", "transmit_delay", "service_delay",
                     "downlink_delay"):
            a, b = g.pop(part), w.pop(part)
            assert (a is None) == (b is None) and (a is None or abs(a - b) <= BREAKDOWN_TOL), part
        assert g == w
    assert got.dispatcher == want.dispatcher
    gs, ws = got.summary(), want.summary()
    for key in ("steps", "outcomes", "dispatcher"):
        assert gs[key] == ws[key], key
    for key in ("mean_offload_latency",):
        assert gs[key] == pytest.approx(ws[key], abs=BREAKDOWN_TOL)
    for k, v in ws["latency_decomposition"].items():
        assert gs["latency_decomposition"][k] == pytest.approx(v, abs=BREAKDOWN_TOL)


FLEETS = {
    "congested": lambda rt: rt.default_congested_fleet(3, seed=3),
    "linked": lambda rt: rt.default_linked_fleet(3, seed=0),
    "linked_fading": lambda rt: rt.default_linked_fleet(3, seed=1, fading=True,
                                                        transmit_time=0.6),
}
SIM = {  # the package that holds each fleet function
    trt: trt, jrt: jsim,
}
POLICIES = {
    "threshold": {},
    "queue_aware": {},
    "value_iteration": dict(max_queue=12, n_sweeps=40, delay_cost=0.03),
}


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("fleet", list(FLEETS))
def test_simulate_linked_fleets_equal_repro(engines, fleet, policy):
    jeng, eng, x = engines
    kw = dict(features=x[:160], ratio=0.35, micro_batch=4, seed=5,
              set_ratio_at={100: 0.2})
    want = jrt.simulate(jeng.with_policy(policy, policy_kwargs=POLICIES[policy]),
                        edges=FLEETS[fleet](SIM[jrt]), **kw)
    got = trt.simulate(eng.with_policy(policy, policy_kwargs=POLICIES[policy]),
                       edges=FLEETS[fleet](trt), **kw)
    same_trace(got, want)
    offloaded = [r for r in got.records if r.outcome == OUTCOME_OFFLOADED]
    assert offloaded and all(r.transmit_delay > 0 for r in offloaded)
    for r in offloaded:
        assert r.latency == pytest.approx(r.queue_delay + r.transmit_delay + r.service_delay
                                          + r.downlink_delay)
    assert "uplink" in got.dispatcher["edges"]["edge0"]


def test_simulate_congested_fleet_reproducible(engines):
    _, eng, x = engines

    def run():
        return trt.simulate(eng.with_policy("queue_aware"), features=x[:120],
                            edges=trt.default_congested_fleet(3, seed=9), ratio=0.35,
                            micro_batch=4, seed=9)

    a, b = run(), run()
    assert a.records == b.records and a.summary() == b.summary()
    assert a.latency_decomposition()["queue"] > 0


def test_value_iteration_solves_on_the_engines_device(engines, tmp_path):
    """``device`` is runtime wiring: the engine and its sessions pass their
    own, and the artifact never holds it."""
    _, eng, _ = engines
    vi = eng.with_policy("value_iteration", policy_kwargs=dict(max_queue=6, n_sweeps=10))
    assert vi.policy.device.type == "cpu"
    session = OffloadSession(vi, state_probe=lambda: (6, 1))
    assert session.policy.device.type == "cpu" and session.policy.theta.shape == (7, 2)
    path = str(tmp_path / "vi")
    vi.save(path)
    loaded = OffloadEngine.load(path, device="cpu")
    assert loaded.policy_name == "value_iteration" and "device" not in loaded.policy_kwargs
    assert loaded.policy_kwargs["max_queue"] == 6
    np.testing.assert_array_equal(loaded.policy.theta, vi.policy.theta)
    qa = eng.with_policy("queue_aware", policy_kwargs=dict(congestion=lambda: 0.0, gain=2.0))
    qa.save(path)
    loaded = OffloadEngine.load(path, device="cpu")
    assert "congestion" not in loaded.policy_kwargs and loaded.policy.congestion is None
