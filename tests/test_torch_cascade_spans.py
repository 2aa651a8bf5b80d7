"""The LM cascade's spans on the port's one tracer, on the CPU at tiny
sizes: the span tree of one ``serve_batch`` (names, parents, the shared
batch id, the root's args, the decision instant before the strong pass),
nothing recorded and no profiler range entered with every switch off, the
``stage_ms`` keys of ``serve_batch``, ``generate`` and ``detection_repro``,
the exported spans on the profiler's clock, the same spans from
``serve_stream``, and the session's engine spans and ``session.flush`` on its
fast and buffered paths."""
import json

import numpy as np
import pytest
import torch

from repro_torch.api import OffloadEngine
from repro_torch.configs import get_config
from repro_torch.data.lm_synth import synth_lm_batch
from repro_torch.models import lm as tlm
from repro_torch.obs import Obs, Tracer
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime import ManualClock, OffloadSession
from repro_torch.serving.cascade_serving import LMCascade
from repro_torch.serving.decode_loop import generate

CASCADE = ["cascade.weak_forward", "cascade.decide", "cascade.nll", "cascade.strong_forward",
           "cascade.nll"]
ENGINE = ["engine.features", "engine.estimator", "engine.policy"]


def _batch(seed, cfg, B=4, S=12):
    toks, labels = synth_lm_batch(np.random.default_rng(seed), B, S, cfg.vocab_size)
    labels[0, S - 3:] = -1  # a padded row
    return {"tokens": toks, "labels": labels}


@pytest.fixture(scope="module")
def tiny():
    cfg = tlm.reduced(get_config("qwen2_7b"), num_layers=2)
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    cascade = LMCascade.fit(params, cfg, exit_layer=1, calib_batches=[_batch(1, cfg, B=16)],
                            ratio=0.25, epochs=2)
    return cascade, params, cfg


def _spans(tracer):
    return [e for e in tracer.to_chrome()["traceEvents"] if e["ph"] == "X"]


def _end(e):
    return e["ts"] + e["dur"]


def test_serve_batch_span_tree(tiny):
    cascade, params, cfg = tiny
    obs = Obs(metrics=False, profiling=False)
    served = LMCascade(cfg=cfg, exit_layer=1, engine=cascade.engine, obs=obs)
    batch = _batch(5, cfg)
    out = served.serve_batch(params, batch)
    spans = _spans(obs.tracer)
    by_id = {e["args"]["id"]: e for e in spans}
    root, = [e for e in spans if e["name"] == "cascade.serve_batch"]
    assert "parent" not in root["args"]
    assert {e["args"]["batch"] for e in spans} == {root["args"]["id"]}
    children = [e for e in spans if e["args"].get("parent") == root["args"]["id"]]
    assert [e["name"] for e in children] == CASCADE
    decide = children[1]
    assert [e["name"] for e in spans if e["args"].get("parent") == decide["args"]["id"]] == ENGINE
    layers = [e for e in spans if e["name"] == "lm.layer"]
    # the weak pass's one layer, then the strong pass's two
    assert [e["args"]["i"] for e in layers] == [0, 0, 1]
    assert [by_id[e["args"]["parent"]]["name"] for e in layers] == \
        ["cascade.weak_forward"] + ["cascade.strong_forward"] * 2
    assert root["args"]["rows"] == 4 and root["args"]["pad"] == 12
    assert root["args"]["scored"] == int((batch["labels"] >= 0).sum())
    assert root["args"]["offloaded"] == int(out["offload"].sum())
    # the decision instant comes before the strong pass opens; children nest
    strong = children[3]
    assert _end(decide) <= strong["ts"]
    for e in spans:
        if "parent" in e["args"]:
            p = by_id[e["args"]["parent"]]
            assert p["ts"] <= e["ts"] and _end(e) <= _end(p) + 1e-3
    # the CPU has no device interval
    assert all("device_ms" not in e["args"] for e in spans)


def test_everything_off_records_nothing(tiny, monkeypatch):
    cascade, params, cfg = tiny

    def refuse(*a, **k):
        raise AssertionError("a profiler range was entered with the profiler off")

    monkeypatch.setattr(obs_trace, "_HostRange", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    served = LMCascade(cfg=cfg, exit_layer=1, engine=cascade.engine)
    served.serve_batch(params, _batch(6, cfg))
    assert served.obs is None
    assert obs_trace.stage(None, "x") is obs_trace.NULL_STAGE
    assert obs_trace.stage(None, "x", stage_ms={}) is obs_trace.NULL_STAGE  # no key


def test_detection_repro_stage_ms_keys(tmp_path, monkeypatch):
    """``build_pipeline``'s stages at a tiny size, and ``run_all``'s one key a
    figure or study (the studies stubbed: their own tests run them)."""
    from repro_torch.experiments import detection_repro as tdr

    stage_ms = {}
    tdr.build_pipeline(n_train=64, n_val=16, n_pool=16, steps_weak=2, steps_strong=2, force=True,
                       verbose=False, device="cpu", cache_dir=str(tmp_path), stage_ms=stage_ms)
    assert set(stage_ms) == {"data_ms", "train_weak_ms", "train_strong_ms", "decode_ms",
                             "match_ms", "map_ms", "features_ms"}
    for name in ("figure5_context_size", "table2_conservatism", "figure6_error_types",
                 "figure8_reward_cdf", "train_estimators", "evaluate_policies",
                 "streaming_multi_edge_study"):
        monkeypatch.setattr(tdr, name, lambda *a, **k: {})
    stage_ms = {}
    tdr.run_all(quick=True, device="cpu", cache_dir=str(tmp_path), stage_ms=stage_ms)
    assert set(stage_ms) == {"figure5_ms", "table2_ms", "figure6_ms", "figure8_ms",
                             "train_estimators_ms", "figure9_10_ms", "streaming_ms"}


def test_stage_ms_keys(tiny):
    cascade, params, cfg = tiny
    stage_ms = {}
    cascade.serve_batch(params, _batch(7, cfg), stage_ms=stage_ms)
    assert set(stage_ms) == {"weak_forward_ms", "decide_ms", "nll_ms", "strong_forward_ms"}
    assert all(v > 0 for v in stage_ms.values())
    gen_ms = {}
    toks = generate(params, cfg, _batch(8, cfg), steps=3, stage_ms=gen_ms)
    assert toks.shape == (4, 3) and set(gen_ms) == {"prefill_ms", "decode_ms"}


def test_profiled_batch_spans_on_the_profilers_clock(tiny):
    """A profiled batch with no ``Obs`` attaches a tracer of its own; its
    exported ``cascade.decide`` lies within 1 ms of the profiler's range of
    the same name, which is a plain op range (no device-side row)."""
    cascade, params, cfg = tiny
    served = LMCascade(cfg=cfg, exit_layer=1, engine=cascade.engine)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        served.serve_batch(params, _batch(9, cfg))
    assert served.obs is not None and served.obs.metrics is None
    doc = json.loads(json.dumps(served.obs.tracer.to_chrome()))
    mine, = [e for e in doc["traceEvents"] if e["name"] == "cascade.decide"]
    theirs = [e for e in prof.profiler.kineto_results.events() if e.name() == "cascade.decide"]
    assert len(theirs) == 1
    assert abs(mine["ts"] - theirs[0].start_ns() / 1e3) < 1e3
    if hasattr(theirs[0], "activity_type"):  # a user annotation would get a device-side row
        assert theirs[0].activity_type() != "user_annotation"
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    # the block halves are profiler ranges only, not tracer spans
    assert {"cascade.serve_batch", "lm.layer", "lm.unstack", "lm.attention", "lm.attention.core",
            "lm.mlp", *ENGINE, *CASCADE} <= names
    assert not {"lm.unstack", "lm.attention", "lm.mlp"} & {e["name"] for e in doc["traceEvents"]}


def test_serve_stream_spans(tiny):
    cascade, params, cfg = tiny
    obs = Obs(metrics=False, profiling=False)
    served = LMCascade(cfg=cfg, exit_layer=1, engine=cascade.engine, obs=obs)
    out = served.serve_stream(params, [_batch(10, cfg), _batch(11, cfg)], micro_batch=4)
    spans = _spans(obs.tracer)
    roots = [e for e in spans if e["name"] == "cascade.serve_batch"]
    assert len(roots) == 2
    assert sum(r["args"]["offloaded"] for r in roots) == int(out["offload"].sum())
    for root in roots:
        kids = [e for e in spans if e["args"].get("parent") == root["args"]["id"]]
        assert [e["name"] for e in kids] == CASCADE
        engine = [e["name"] for e in spans if e["name"].startswith("engine.")
                  and e["args"]["batch"] == root["args"]["id"]]
        assert engine == ENGINE


@pytest.fixture(scope="module")
def engine():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (128, 6)).astype(np.float32)
    eng = OffloadEngine(ratio=0.3, device="cpu")
    eng.fit(features=x, rewards=x[:, 0] + 0.1 * rng.normal(size=128))
    return eng


def _session_spans(engine, feats, fast):
    obs = Obs(metrics=False, profiling=False)
    sess = OffloadSession(engine, micro_batch=64, obs=obs)
    if fast:
        out = sess.submit_batch(feats)
    else:
        out = sess.submit_batch(feats, flush=False) + sess.flush()
    return out, [e for e in obs.tracer.to_chrome()["traceEvents"] if e["ph"] == "X"]


def test_session_fast_and_buffered_paths_emit_the_same_engine_spans(engine):
    """No adapter: the weak outputs are the features, and each path opens
    the engine's three stages once for a batch under one micro-batch."""
    feats = np.random.default_rng(3).normal(0, 1, (16, 6)).astype(np.float32)
    fast_out, fast = _session_spans(engine, feats, True)
    slow_out, slow = _session_spans(engine, feats, False)
    assert [d.offload for d in fast_out] == [d.offload for d in slow_out]
    engine_names = lambda evs: [e["name"] for e in evs if e["name"].startswith("engine.")]  # noqa: E731
    assert engine_names(fast) == engine_names(slow) == ["engine.features", "engine.estimator",
                                                        "engine.policy"]


def test_session_flush_on_the_fast_path_has_a_length(engine):
    obs = Obs(metrics=False, profiling=False)
    sess = OffloadSession(engine, micro_batch=8, obs=obs)
    sess.submit_batch(np.random.default_rng(4).normal(0, 1, (32, 6)).astype(np.float32))
    flush, = [e for e in obs.tracer.to_chrome()["traceEvents"] if e["name"] == "session.flush"]
    assert flush["dur"] > 0 and flush["args"]["frames"] == 32
    est, = [e for e in obs.tracer.to_chrome()["traceEvents"] if e["name"] == "engine.estimator"]
    assert flush["ts"] <= est["ts"]


def test_simulation_clock_keeps_its_own_spans(engine):
    """A session on a bound simulation clock records its flush spans only,
    unshifted: the engine's stages time wall-clock work."""
    obs = Obs(metrics=False, profiling=False)
    clock = ManualClock()
    obs.bind_clock(clock)
    sess = OffloadSession(engine, micro_batch=8, obs=obs)
    clock.advance(2.0)
    sess.submit_batch(np.zeros((8, 6), np.float32))
    evs = [e for e in obs.tracer.to_chrome()["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in evs] == ["session.flush"] and evs[0]["ts"] == 2000.0


def test_wall_tracer_exports_on_the_epoch_clock():
    tr = Tracer()
    import time

    before = time.time_ns() / 1e3
    with tr.span("s"):
        pass
    after = time.time_ns() / 1e3
    ev, = [e for e in tr.to_chrome()["traceEvents"] if e["name"] == "s"]
    assert before - 1e3 <= ev["ts"] <= after + 1e3
