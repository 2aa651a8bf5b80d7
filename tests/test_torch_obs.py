"""The port's observability plane against the JAX package's, on the CPU,
case by case after ``tests/test_obs.py``: the instrument/registry core, the
manual-clock tracer, kernel launch accounting (where ``repro`` counts jit
retraces), the dispatch profiler, and the contracts the serve stack holds
when an ``Obs`` handle rides along — telemetry identical with observability
on, off and noop; byte-identical exports across seeded runs; and exports
equal to ``repro``'s apart from the retrace lines (estimate sums at 1e-5)."""
import json

import numpy as np
import pytest

import repro.detection.batch  # noqa: F401  (first: repro's kernels import it back)
import repro.obs as jobs
import repro.runtime as jrt
from repro.api import MLPRewardModel as JMLPRewardModel
from repro.api import OffloadEngine as JOffloadEngine
from repro.core import EstimatorConfig as JEstimatorConfig

from repro_torch.api import OffloadEngine
from repro_torch.kernels import _build
from repro_torch.kernels.estimator_mlp import estimator_mlp
from repro_torch.obs import (
    DEFAULT_TIME_BUCKETS,
    Counter,
    DispatchProfiler,
    Gauge,
    Histogram,
    MetricsRegistry,
    Obs,
    Tracer,
    kernel_stats,
)
import repro_torch.runtime as trt
from repro_torch.runtime import ManualClock

EST_TOL = 1e-5


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """``repro`` fits and saves; the port loads the artifact on the CPU."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (256, 12)).astype(np.float32)
    rewards = 2.0 * x[:, 0] + 0.3 * rng.normal(size=256)
    jeng = JOffloadEngine(
        reward_model=JMLPRewardModel(
            config=JEstimatorConfig(hidden=(16,), epochs=15, batch_size=64)
        ),
        ratio=0.3,
    )
    jeng.fit(features=x, rewards=rewards)
    path = str(tmp_path_factory.mktemp("obs") / "engine")
    jeng.save(path)
    return jeng, OffloadEngine.load(path, device="cpu"), x


# ------------------------------------------------------------- instruments


def test_counter_stays_int_under_int_increments():
    c = Counter("c")
    c.inc()
    c.inc(3)
    assert c.value == 4 and isinstance(c.value, int)
    c.inc(0.5)
    assert isinstance(c.value, float)


def test_gauge_set_and_callback():
    g = Gauge("g")
    g.set(2.5)
    assert g.value == 2.5
    state = {"x": 7}
    live = Gauge("live", fn=lambda: state["x"])
    assert live.value == 7
    state["x"] = 9
    assert live.value == 9


def test_histogram_buckets_and_stats():
    h = Histogram("h", buckets=(1.0, 2.0, 4.0))
    for v in (0.5, 1.5, 3.0, 100.0):
        h.observe(v)
    assert list(h.counts) == [1, 1, 1, 1]  # one per bucket + overflow
    assert h.n == 4
    assert h.sum == pytest.approx(105.0)
    assert h.mean == pytest.approx(105.0 / 4)
    assert h.collect() == jobs.Histogram("h", buckets=(1.0, 2.0, 4.0)).collect() | {
        "counts": [1, 1, 1, 1], "sum": 105.0, "count": 4}


def test_histogram_rejects_unsorted_buckets():
    with pytest.raises(ValueError):
        Histogram("h", buckets=(2.0, 1.0))
    Histogram("h", buckets=(1.0, 2.0, 4.0))
    assert DEFAULT_TIME_BUCKETS == jobs.DEFAULT_TIME_BUCKETS


def test_registry_get_or_create_and_labels():
    reg = MetricsRegistry()
    a = reg.counter("hits", {"edge": "e0"})
    b = reg.counter("hits", {"edge": "e0"})
    c = reg.counter("hits", {"edge": "e1"})
    assert a is b and a is not c
    a.inc(2)
    snap = reg.snapshot()
    assert snap['hits{edge="e0"}'] == 2
    assert snap['hits{edge="e1"}'] == 0
    with pytest.raises(TypeError):
        reg.gauge("hits", {"edge": "e0"})


def test_registry_callback_gauge_rebinds_fn():
    reg = MetricsRegistry()
    reg.gauge("depth", fn=lambda: 1)
    g = reg.gauge("depth", fn=lambda: 2)
    assert g.value == 2
    assert reg.snapshot()["depth"] == 2


def test_registry_delta():
    reg = MetricsRegistry()
    c = reg.counter("n")
    h = reg.histogram("h", buckets=(1.0,))
    prev = reg.snapshot()
    c.inc(5)
    h.observe(0.5)
    d = MetricsRegistry.delta(prev, reg.snapshot())
    assert d["n"] == 5
    assert d["h"] == {"buckets": [1.0], "counts": [1, 0], "sum": 0.5, "count": 1}


def test_prometheus_exposition_matches_repro():
    """The same instruments give repro's exposition text byte for byte."""
    texts = []
    for mod in (MetricsRegistry, jobs.MetricsRegistry):
        reg = mod()
        h = reg.histogram("lat", buckets=(1.0, 2.0), help="latency")
        for v in (0.5, 1.5, 9.0):
            h.observe(v)
        reg.counter("hits", {"edge": "e0"}).inc(3)
        reg.gauge("ratio", fn=lambda: 0.25)
        reg.gauge("nan").set(float("nan"))
        reg.collector(lambda: [("extra", {"k": "v"}, 7, "counter")])
        texts.append(reg.to_prometheus())
    text = texts[0]
    assert text == texts[1]
    assert '# TYPE lat histogram' in text
    assert 'lat_bucket{le="1.0"} 1' in text
    assert 'lat_bucket{le="2.0"} 2' in text
    assert 'lat_bucket{le="+Inf"} 3' in text
    assert "lat_count 3" in text and "nan NaN" in text


def test_registry_json_roundtrip(tmp_path):
    reg = MetricsRegistry()
    reg.counter("a").inc(3)
    p = tmp_path / "m.json"
    reg.export_json(str(p))
    payload = json.loads(p.read_text())
    assert any(s["name"] == "a" and s["value"] == 3 for s in payload["series"])


# ------------------------------------------------------------------ tracer


def test_tracer_manual_clock_spans():
    clock = ManualClock()
    tr = Tracer()
    tr.bind_clock(clock)
    t0 = tr.clock()
    clock.advance(2.0)
    tr.add_span("work", t0, tr.clock(), tid=1, args={"k": 1})
    with tr.span("block", tid=2, n=3):
        clock.advance(0.5)
    tr.instant("mark", tid=1)
    doc = tr.to_chrome()
    evs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(evs) == 2
    assert evs[0]["name"] == "work" and evs[0]["dur"] == pytest.approx(2000.0)
    assert evs[1]["args"] == {"n": 3} and evs[1]["dur"] == pytest.approx(500.0)


def test_tracer_async_pairs_share_id():
    tr = Tracer()
    tr.bind_clock(ManualClock())
    jid = tr.next_id()
    tr.add_async_span("offload", 0.0, 3.0, id=jid, tid=5)
    evs = tr.to_chrome()["traceEvents"]
    b = [e for e in evs if e["ph"] == "b"]
    e = [e for e in evs if e["ph"] == "e"]
    assert len(b) == 1 and len(e) == 1
    assert b[0]["id"] == e[0]["id"]


def test_tracer_overflow_drops_not_grows():
    tr = Tracer(max_events=4)
    tr.bind_clock(ManualClock())
    for _ in range(10):
        tr.add_span("s", 0.0, 1.0, tid=0)
    doc = tr.to_chrome()
    assert len([e for e in doc["traceEvents"] if e["ph"] == "X"]) <= 4
    meta = [e for e in doc["traceEvents"] if e.get("name") == "trace_overflow"]
    assert meta and meta[0]["args"]["dropped"] == 6
    tr.clear()
    assert tr.to_chrome()["traceEvents"] == []


# ------------------------------------------------------------ kernel stats


def test_kernel_stats_sites_cover_every_kernel():
    """Every ported Pallas kernel's wrapper is a counted site."""
    snap = kernel_stats.snapshot()
    assert set(snap) == {"launches", "builds", "calls"}
    assert set(snap["launches"]) == {"iou_matrix", "iou_matrix_batch", "estimator_mlp",
                                     "score_pipeline", "flash_sdpa", "wkv6"}


def test_kernel_stats_counts_launches_not_plain_calls(engines):
    """On the CPU the wrappers take their plain versions and count nothing;
    growth of a wrapper's counter and a build shows in the delta and in the
    ``Obs`` export, relative to the handle's construction."""
    _, eng, x = engines
    before = kernel_stats.snapshot()
    obs = Obs()
    eng.score(features=x)
    eng.score(features=x[: len(x) // 2])
    assert all(n == 0 for n in kernel_stats.delta(before, kernel_stats.snapshot())["launches"].values())
    saved = estimator_mlp.launches, dict(_build.BUILDS)
    try:
        estimator_mlp.launches += 3  # as three launches on the card would
        _build.BUILDS["estimator_mlp"] = _build.BUILDS.get("estimator_mlp", 0) + 1
        delta = obs.kernel_delta()
        assert delta["launches"]["estimator_mlp"] == 3
        assert delta["launches"]["score_pipeline"] == 0
        assert delta["builds"]["estimator_mlp"] == 1
        text = obs.metrics.to_prometheus()
        assert 'repro_kernel_launches_total{kernel="estimator_mlp"} 3' in text
        assert 'repro_kernel_launches_total{kernel="wkv6"} 0' in text
        assert 'repro_kernel_builds_total{source="estimator_mlp"} 1' in text
    finally:
        estimator_mlp.launches = saved[0]
        _build.BUILDS.clear()
        _build.BUILDS.update(saved[1])
    assert "repro_kernel_builds_total" not in Obs().metrics.to_prometheus()


# ---------------------------------------------------------------- profiler


def test_profiler_report_shares_sum_to_one():
    prof = DispatchProfiler()
    for phase, n in (("a", 3), ("b", 2)):
        for _ in range(n):
            t0 = prof.begin()
            prof.add(phase, t0)
    rep = prof.report()
    assert set(rep) == {"a", "b"}
    assert sum(row["share"] for row in rep.values()) == pytest.approx(1.0)
    assert {phase: row["count"] for phase, row in rep.items()} == {"a": 3, "b": 2}
    assert "phase" in prof.format_report()
    prof.clear()
    assert prof.totals() == {}


# ------------------------------------------------------------- obs handle


def test_noop_handle_disables_every_plane():
    obs = Obs.noop()
    assert obs.metrics is None and obs.tracer is None and obs.profiler is None
    assert not obs.enabled
    assert Obs().enabled


# --------------------------------------------- byte-stability of telemetry


def run(engine, x, obs, rt=trt, n=128, micro_batch=16):
    return rt.simulate(
        engine, features=x[:n], edges=rt.default_edge_fleet(3, seed=0),
        ratio=0.3, micro_batch=micro_batch, seed=0, obs=obs,
    )


def test_session_telemetry_byte_stable_under_obs(engines):
    """On the congested netsim fleet, as repro's test runs it."""
    _, eng, x = engines

    def run(obs):
        return trt.simulate(
            eng, features=x[:128], edges=trt.default_congested_fleet(3, seed=0),
            ratio=0.3, micro_batch=16, seed=0, obs=obs,
        )

    base = run(None)
    assert base.latency_decomposition()["transmit"] > 0.0
    for handle in (Obs(), Obs.noop(), Obs(metrics=False), Obs(tracing=False)):
        trace = run(handle)
        assert trace.records == base.records
        for kwargs in (
            {},
            {"include_video": True},
            {"include_online": True},
            {"include_fleet": True},
        ):
            assert trace.telemetry.as_dict(**kwargs) == base.telemetry.as_dict(**kwargs), kwargs


# --------------------------------------------- deterministic export bytes


def test_exports_byte_identical_across_seeded_runs(engines, tmp_path):
    _, eng, x = engines
    payloads = []
    for i in range(2):
        obs = Obs()
        run(eng, x, obs, n=96)
        mp, tp = tmp_path / f"m{i}.json", tmp_path / f"t{i}.json"
        obs.metrics.export_json(str(mp))
        obs.tracer.export(str(tp))
        payloads.append((mp.read_bytes(), tp.read_bytes()))
    assert payloads[0][0] == payloads[1][0], "metrics export not deterministic"
    assert payloads[0][1] == payloads[1][1], "trace export not deterministic"


def _series(text, drop):
    """{series: value} of an exposition text, without the lines whose metric
    name starts with ``drop``."""
    out = {}
    for line in text.splitlines():
        name = line.split()[2] if line.startswith("#") else line.split("{")[0].split()[0]
        if name.startswith(drop):
            continue
        key, _, value = line.rpartition(" ")
        out[key] = value
    return out


def test_exports_equal_repro(engines):
    """The same seeded stream observed in both packages: every series equal
    (estimate sums at 1e-5), the retrace lines in place of the launch
    lines; the trace equal event for event."""
    jeng, eng, x = engines
    mine, ref = Obs(), jobs.Obs()
    run(eng, x, mine, n=200, micro_batch=8)
    run(jeng, x, ref, rt=jrt, n=200, micro_batch=8)
    got = _series(mine.metrics.to_prometheus(), "repro_kernel_")
    want = _series(ref.metrics.to_prometheus(), "repro_jit_")
    assert list(got) == list(want)
    for key, value in got.items():
        if key.startswith("repro_estimate_sum_total"):
            assert float(value) == pytest.approx(float(want[key]), abs=EST_TOL * 200)
        else:
            assert value == want[key], key
    assert mine.tracer.to_chrome() == ref.tracer.to_chrome()
    assert 'repro_kernel_launches_total{kernel="estimator_mlp"} 0' in mine.metrics.to_prometheus()


# ------------------------------------------ runtime trace validity and nesting


def test_simulate_trace_valid_and_nested(engines):
    """Track layout (driver 0, session 1, edges 100+), one flush span per
    drain, and every edge offload group inside the run after a flush."""
    _, eng, x = engines
    obs = Obs()
    trace = run(eng, x, obs, n=128, micro_batch=16)
    doc = json.loads(json.dumps(obs.tracer.to_chrome()))  # valid JSON
    evs = doc["traceEvents"]
    assert {"session.flush", "offload", "result.return"} <= {e["name"] for e in evs}
    tracks = {e["args"]["name"]: e["tid"] for e in evs if e["ph"] == "M"}
    assert tracks["runtime"] == 0 and tracks["session:0"] == 1
    assert all(v >= 100 for k, v in tracks.items() if k.startswith("edge:"))
    flushes = [e for e in evs if e["name"] == "session.flush"]
    assert len(flushes) == 128 // 16
    assert sum(f["args"]["frames"] for f in flushes) == 128
    assert sum(f["args"]["offloaded"] for f in flushes) == trace.telemetry.offloaded
    offloads = [e for e in evs if e["name"] == "offload" and e["ph"] == "b"]
    first_flush = min(f["ts"] for f in flushes)
    assert offloads and all(o["tid"] >= 100 and o["ts"] >= first_flush for o in offloads)
    ends = {e["id"]: e["ts"] for e in evs if e["name"] == "offload" and e["ph"] == "e"}
    for e in evs:
        if e["name"] == "service" and e["ph"] == "b":
            parent = next(o for o in offloads if o["id"] == e["id"])
            assert parent["ts"] <= e["ts"] <= ends[e["id"]]


def test_simulate_prometheus_exposes_required_series(engines):
    _, eng, x = engines
    obs = Obs()
    run(eng, x, obs, n=64)
    text = obs.metrics.to_prometheus()
    for series in (
        "repro_realized_ratio",
        "repro_dispatch_total",
        "repro_edge_queue_depth",
        "repro_offload_rtt",
        "repro_kernel_launches_total",
        "repro_frames_processed_total",
    ):
        assert series in text, series
    assert 'repro_frames_processed_total{stream="0"} 64' in text


# --------------------------------------------------- runtime obs plumbing


def test_simulate_profiler_attributes_phases(engines):
    _, eng, x = engines
    obs = Obs(metrics=False, tracing=False)
    run(eng, x, obs, n=64)
    phases = obs.profiler.report()
    assert {"serve.submit", "serve.settle", "session.score", "session.decide",
            "serve.features"} <= set(phases)
    assert phases["session.score"]["count"] == 64 // 16
    assert phases["serve.submit"]["count"] == 64
