"""``repro_torch.examples`` on the CPU, at small sizes, held against the JAX
package's ``examples/`` scripts.

The seeded scenarios serve ``repro``'s fitted engine: the JAX script's own
``fitted_engine`` (or the ``repro`` calls it makes) fits it, ``save`` writes
it and the port loads it on the CPU in place of its own fit, so records,
realized ratios and decisions are held equal to ``repro``'s call with the
script's arguments (estimates at 1e-5, the MLP tolerance).  The quickstart
runs on ``repro``-trained detector weights; the LM pair crosses checkpoints
both ways.  ``examples/fleet_scale.py`` is not imported: it sets
``XLA_FLAGS`` when imported.
"""
import dataclasses
import importlib
import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.detection.batch  # noqa: F401  (first: repro's kernels import it back)
import jax
import jax.numpy as jnp
import repro.mobility as jm
import repro.runtime as jrt
import repro.video as jv
from repro.api import MLPRewardModel as JMLPRewardModel
from repro.api import OffloadEngine as JOffloadEngine
from repro.core import EstimatorConfig as JEstimatorConfig

import repro_torch.examples as ex
from _torch_parity import repro_init  # noqa: F401  (a shared fixture)
from repro_torch.api import OffloadEngine

ROOT = Path(__file__).resolve().parents[1]
EST_TOL = 1e-5  # tests/test_kernels.py's MLP tolerance
MAP_TOL = 1e-4  # tests/test_torch_pipeline.py's mAP tolerance
LM_TOL = 1e-3  # end-to-end LM estimates (ROADMAP, "Holding a slice")


def example(name):
    return importlib.import_module(f"repro_torch.examples.{name}")


def jax_script(name):
    """The JAX package's ``examples/<name>.py``, imported from its file."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """Artifacts and output files in ``tmp_path``."""
    monkeypatch.setattr(ex, "ARTIFACTS", str(tmp_path / "artifacts"))
    monkeypatch.chdir(tmp_path)
    return tmp_path


def crossed(jeng, tmp_path, name="engine"):
    """``repro``'s fitted engine, saved and loaded by the port on the CPU."""
    path = str(tmp_path / name)
    jeng.save(path)
    return OffloadEngine.load(path, device="cpu")


class Spy:
    """Records what a wrapped function returned."""

    def __init__(self, fn):
        self.fn, self.results = fn, []

    def __call__(self, *args, **kwargs):
        self.results.append(self.fn(*args, **kwargs))
        return self.results[-1]


def same_trace(got, want):
    """Record for record, everything exact but the estimates."""
    assert len(got.records) == len(want.records)
    for g, w in zip(got.records, want.records):
        g, w = g.as_dict(), w.as_dict()
        assert g.pop("estimate") == pytest.approx(w.pop("estimate"), abs=EST_TOL)
        assert g == w
    assert got.dispatcher == want.dispatcher
    assert got.telemetry.realized_ratio == want.telemetry.realized_ratio


# ------------------------------------------------------------ the CPU rule


@pytest.mark.parametrize("name", ex.MODULES)
def test_main_raises_without_a_card_unless_asked_for_the_cpu(name, monkeypatch):
    mod = example(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main([])
    assert mod.parser(mod.__doc__).parse_args([]).device == "cuda"
    assert mod.parser(mod.__doc__).parse_args(["--device", "cpu"]).device == "cpu"


def test_artifacts_are_the_jax_scripts():
    want = os.environ.get("REPRO_ARTIFACTS", ROOT / "examples" / "../artifacts")
    assert Path(ex.ARTIFACTS).resolve() == Path(want).resolve()
    assert set(ex.MODULES) == {p.stem for p in (ROOT / "examples").glob("*.py")}
    assert example("train_lm").CKPT == "lm_100m.npz"


# ------------------------------------------------- seeded runtime scenarios


def test_stream_offload_equals_repro(workdir, monkeypatch):
    js = jax_script("stream_offload")
    jeng = js.fitted_engine(400, 48)
    mod = example("stream_offload")
    monkeypatch.setattr(mod, "fitted_engine",
                        lambda n, d, seed=0, device=None: crossed(jeng, workdir))
    spy = Spy(mod.simulate)
    monkeypatch.setattr(mod, "simulate", spy)
    out = mod.run("cpu", n_calib=400, n_frames=64)

    stream = np.random.default_rng(42).normal(0, 1, (64, 48)).astype(np.float32)
    want = jrt.simulate(jeng, features=stream, edges=jrt.default_edge_fleet(3, seed=1),
                        strategy="least_loaded", ratio=0.25, micro_batch=16,
                        set_ratio_at={32: 0.5}, seed=1)
    assert len(spy.results) == 2 and out["rerun_equal"]
    same_trace(spy.results[0], want)
    s = want.summary()
    assert out["outcomes"] == s["outcomes"]
    assert out["realized_ratio"] == s["telemetry"]["realized_ratio"]
    assert out["mean_offload_latency"] == s["mean_offload_latency"]
    for strategy, counts in out["burst"].items():
        tr = jrt.OffloadRuntime(jeng, jrt.default_edge_fleet(3, seed=2), strategy=strategy,
                                seed=2).serve(features=stream, ratio=0.6, micro_batch=64)
        assert counts == {k: tr.outcome_counts().get(k, 0) for k in counts}, strategy


def test_observability_equals_repro(workdir, monkeypatch):
    from repro.obs import Obs as JObs

    js = jax_script("observability")
    jeng = js.fitted_engine(300, 24)
    mod = example("observability")
    monkeypatch.setattr(mod, "fitted_engine",
                        lambda n, d, seed=0, device=None: crossed(jeng, workdir))
    out = mod.run("cpu", n_calib=300, n_frames=64)
    trace = json.loads((workdir / mod.TRACE_FILE).read_text())
    metrics = json.loads((workdir / mod.METRICS_FILE).read_text())

    stream = np.random.default_rng(7).normal(0, 1, (64, 24)).astype(np.float32)
    obs = JObs()
    want = jrt.simulate(jeng, features=stream, edges=jrt.default_congested_fleet(3, seed=5),
                        ratio=0.3, micro_batch=32, seed=5, obs=obs)
    t = want.telemetry
    assert (out["processed"], out["offloaded"], out["realized_ratio"]) == (
        t.processed, t.offloaded, t.realized_ratio)
    shown = [line for line in obs.metrics.to_prometheus().splitlines()
             if line.startswith(mod.SHOWN[:-1])]
    assert [line for line in out["prometheus"] if line.startswith(mod.SHOWN[:-1])] == shown
    assert any(line.startswith("repro_kernel_launches_total") for line in out["prometheus"])
    assert len(trace["traceEvents"]) > out["n_events"] > 0 and metrics


def test_netsim_congestion_equals_repro(workdir, monkeypatch):
    from repro.netsim import value_iteration_sweep as j_sweep

    js = jax_script("netsim_congestion")
    jeng = js.fitted_engine(300, 24)
    mod = example("netsim_congestion")
    monkeypatch.setattr(mod, "fitted_engine",
                        lambda n, d, seed=0, device=None: crossed(jeng, workdir))
    spy = Spy(mod.simulate)
    monkeypatch.setattr(mod, "simulate", spy)
    out = mod.run("cpu", n_calib=300, n_frames=50)

    from repro.netsim import GilbertElliottLink, UplinkQueue

    queue = UplinkQueue(GilbertElliottLink(bandwidth=0.5, bad_bandwidth=0.125, p_gb=0.1,
                                           p_bg=0.3, seed=4), depth=6, frame_bits=1.0)
    frames = [queue.enqueue(0.6 * step, step) for step in range(8)]
    queue.poll(1e9)
    assert out["queue"]["frames"] == [
        None if f is None else (f.queue_delay, f.transmit_delay, f.t_delivered) for f in frames]
    assert out["queue"]["stats"] == queue.stats()

    stream = np.random.default_rng(42).normal(0, 1, (50, 24)).astype(np.float32)
    engines = [jeng, jeng.with_policy("queue_aware"), jeng.with_policy(
        "value_iteration", policy_kwargs=dict(max_queue=12, delay_cost=0.03))]
    assert len(spy.results) == len(engines)
    for got, eng in zip(spy.results, engines):
        same_trace(got, jrt.simulate(eng, features=stream,
                                     edges=jrt.default_congested_fleet(3, seed=5),
                                     ratio=0.35, micro_batch=1, seed=5))
    want = j_sweep(jeng.calibration_scores, list(mod.SWEEP_RATIOS), max_queue=8, n_sweeps=60)
    np.testing.assert_allclose(out["thetas"], want, atol=EST_TOL, rtol=EST_TOL)


def test_online_adaptation_equals_repro(workdir, monkeypatch):
    from repro.online import DriftConfig, DriftDetector, NetworkEstimator

    mod = example("online_adaptation")
    rng = np.random.default_rng(0)  # the script's netstate_demo draws
    x = rng.normal(0, 1, (128, 32)).astype(np.float32)
    rewards = 2.0 * x[:, 0] + 0.3 * rng.normal(size=128)
    jeng = JOffloadEngine(reward_model=JMLPRewardModel(
        config=JEstimatorConfig(hidden=(16,), epochs=10, batch_size=64)), ratio=0.3)
    jeng.fit(features=x, rewards=rewards)
    monkeypatch.setattr(mod, "netstate_engine",
                        lambda x_, r_, device=None: crossed(jeng, workdir))
    spy = Spy(mod.simulate)
    monkeypatch.setattr(mod, "simulate", spy)
    out = mod.run("cpu", n_probe=128, n_streams=2, n_frames=48, shift_at=16)

    det = DriftDetector(DriftConfig())
    r = np.random.default_rng(0)
    for v in -0.12 + 0.05 * r.normal(size=300):
        det.update(predicted=0.0, realized=v)
    assert out["drift"]["bias_statistic"] == det.statistic and not out["drift"]["bias_drifted"]
    fired = None
    for i, v in enumerate(0.30 + 0.05 * r.normal(size=50)):
        det.update(predicted=0.0, realized=v)
        fired = i + 1 if det.drifted and fired is None else fired
    assert (out["drift"]["fired_at"], out["drift"]["ratio_multiplier"]) == (
        fired, det.ratio_multiplier())

    qa = jeng.with_policy("queue_aware")
    for got, net in zip(spy.results, (None, NetworkEstimator())):
        want = jrt.simulate(qa, features=x, edges=jrt.default_congested_fleet(3, seed=0),
                            ratio=0.3, micro_batch=1, seed=0, net_state=net)
        same_trace(got, want)
    assert out["netstate"]["measured RTT"]["rtt"] == net.telemetry()["rtt"]
    h = out["headline"]
    assert set(h) == {"frozen", "adaptive", "updates", "gain"}
    assert h["updates"]["observations"] > 0


def test_mobility_handover_equals_repro(workdir, monkeypatch):
    mod = example("mobility_handover")
    jscn = jm.default_mobile_scenario(n_clients=2, n_steps=40, seed=0)
    real = mod.default_mobile_scenario

    def scenario(*args, **kwargs):
        return dataclasses.replace(real(*args, **kwargs), engine=crossed(jscn.engine, workdir))

    monkeypatch.setattr(mod, "default_mobile_scenario", scenario)
    out = mod.run("cpu", n_clients=2, n_steps=40)
    for model, m in out["motion"].items():
        assert m["rerun_identical"], model
        assert m["max_abs"] == 0.0 if model == "waypoint" else m["max_abs"] <= 1e-3
    for name, mode in (("static pin", "static"), ("handover", "handover")):
        want = jm.run_mobile_scenario(jscn, mode)
        assert out["headline"][name] == {"effective_acc": want.mean_effective_accuracy(),
                                         "realized_ratio": want.realized_ratio(),
                                         "handovers": want.n_handovers()}, name
    for mode, got in out["in_flight"].items():
        want = jm.run_mobile_scenario(jscn, "handover", in_flight=mode)
        assert got["effective_acc"] == want.mean_effective_accuracy(), mode
        assert got["cancelled"] == sum(e.get("cancelled", 0)
                                       for e in want.dispatcher["edges"].values())
    cov = jm.CoverageMap(jm.default_stations(3, area=(1200.0, 600.0)))
    trace = np.stack([np.linspace(50.0, 1150.0, 60), np.full(60, 300.0)], axis=-1)
    for row in out["coverage"]:
        best, rss = cov.best(trace[row["t"]])
        assert (row["best"], row["rss"], row["time_to_loss"]) == (
            best, rss, cov.time_to_loss(trace, row["t"], dt=1.0))


def test_video_offload_equals_repro(workdir, monkeypatch):
    mod = example("video_offload")
    jscn = jv.default_video_scenario(2, 24, seed=0)
    real = mod.default_video_scenario

    def scenario(*args, **kwargs):
        scn = real(*args, **kwargs)
        scn.engine = crossed(jscn.engine, workdir)
        return scn

    monkeypatch.setattr(mod, "default_video_scenario", scenario)
    out = mod.run("cpu", n_streams=2, n_frames=24)
    clip = jv.generate_clip(2, 24, seed=4)
    hist = jv.track_clip(jv.synthesize_detections(clip, jv.WEAK_PROFILE, seed=5))
    assert out["cuts"] == np.flatnonzero(clip.cuts[:, 0]).tolist()
    assert out["n_active"] == np.asarray(hist.n_active[:, 0]).tolist()
    for policy, got in out["policies"].items():
        want = jv.run_video_scenario(jscn, policy, ratio=0.3)
        s = want.staleness_profile()
        assert got == {"realized_ratio": want.realized_ratio(),
                       "effective_acc": want.mean_effective_accuracy(),
                       "covered": s["covered_fraction"],
                       "mean_staleness": s["mean_staleness"]}, policy


# --------------------------------------------------------- the pipelines


def test_quickstart_equals_repro_on_repro_weights(workdir, monkeypatch, repro_init):
    """Both packages at 64 / 32 / 32 images, 3 steps, the port's detectors
    carrying ``repro``'s trained (then sharpened) weights."""
    from repro.core import CdfTransform, RewardEstimator, RewardOracle, cascade_map
    from repro.core import extract_features_batch, match_pairs, random_offload_mask
    from repro.core import topk_offload_mask
    from repro.data.shapes import ShapesDataset
    from repro.detection.map_engine import dataset_map, match_detections
    from repro.models.detector import STRONG, WEAK, decode_detections
    from repro.train.trainer import train_detector

    from repro_torch.convert import detector_params_from_jax
    from repro_torch.models.detector import Detector

    sizes = dict(n_train=64, n_val=32, n_pool=32, steps_weak=3, steps_strong=3,
                 context_size=16, epochs=2)
    train = ShapesDataset.generate(64, seed=0)
    weights = {}
    for cfg, steps in ((WEAK, 3), (STRONG, 3)):
        params, _ = train_detector(cfg, train, steps=steps, log_every=0)
        w, b = np.array(params["head_out"]["w"]), np.array(params["head_out"]["b"])
        w[..., 1 : 1 + cfg.num_classes] *= 6.0
        b[0] = 3.0
        weights[cfg.name] = dict(params, head_out={"w": jnp.asarray(w), "b": jnp.asarray(b)})

    mod = example("quickstart")

    def port_train(cfg, dataset, steps, log_every=0, device=None):
        det = Detector(cfg, device="cpu")
        det.load_state_dict(detector_params_from_jax(
            jax.tree.map(np.asarray, weights[cfg.name])))
        return det, []

    monkeypatch.setattr(mod, "train_detector", port_train)
    out = mod.run("cpu", **sizes)

    val = ShapesDataset.generate(32, seed=1)
    pool = ShapesDataset.generate(32, seed=2)
    weak_val = decode_detections(weights["weak"], WEAK, val.images)
    strong_val = decode_detections(weights["strong"], STRONG, val.images)
    weak_pool = decode_detections(weights["weak"], WEAK, pool.images)
    assert out["weak_map"] > 0
    assert out["weak_map"] == pytest.approx(dataset_map(weak_val, val.gts), abs=MAP_TOL)
    assert out["strong_map"] == pytest.approx(dataset_map(strong_val, val.gts), abs=MAP_TOL)
    rng = np.random.default_rng(0)
    pairs = match_pairs(weak_val, strong_val, val.gts)
    oracle = RewardOracle.from_pool(
        [match_detections(d, g, (0.5,)) for d, g in zip(weak_pool, pool.gts)], 16, rng)
    rewards = oracle.oric_batch(pairs)
    np.testing.assert_allclose(out["rewards"], rewards, atol=EST_TOL)
    x = extract_features_batch(weak_val, 8, image_size=64.0)
    est = RewardEstimator(x.shape[1], JEstimatorConfig(epochs=2))
    est.fit(x, CdfTransform(rewards)(rewards))
    preds = est.predict(x)
    want = {
        "weak only": cascade_map(pairs, np.zeros(len(pairs), bool)),
        "strong only": cascade_map(pairs, np.ones(len(pairs), bool)),
        "random @20%": cascade_map(pairs, random_offload_mask(len(pairs), 0.2, rng)),
        "ORIC oracle @20%": cascade_map(pairs, topk_offload_mask(rewards, 0.2)),
        "MORIC estimator @20%": cascade_map(pairs, topk_offload_mask(preds, 0.2)),
    }
    assert out["rows"] == pytest.approx(want, abs=MAP_TOL)


def test_offload_detection_round_trip_exact_and_crosses(workdir, monkeypatch):
    import repro_torch.experiments.detection_repro as tdr
    from repro_torch.detection.batch import DetectionsBatch

    real = tdr.build_pipeline

    def tiny(*args, **kwargs):
        kwargs.update(n_train=64, n_val=32, n_pool=32, steps_weak=3, steps_strong=3)
        return real(*args, **kwargs)

    mod = example("offload_detection")
    monkeypatch.setattr(tdr, "ARTIFACTS", str(workdir / "cache"))
    monkeypatch.setattr(tdr, "build_pipeline", tiny)
    monkeypatch.setattr(mod, "build_pipeline", tiny)
    out = mod.run("cpu", quick=True, force=True)
    assert out["round_trip_exact"] and out["n_probe"] == 32
    assert out["engine_path"] == str(workdir / "artifacts" / "offload_engine")
    assert 0.0 <= out["probe_ratio"] <= 1.0 and out["rebudget_ratio"] >= out["probe_ratio"]
    # the port's artifact decides in repro as in the port
    state = tiny(device="cpu", cache_dir=str(workdir / "cache"))
    probe = state.weak_dets_val[:32]
    port = OffloadEngine.load(out["engine_path"], device="cpu")
    got = port.decide(DetectionsBatch.from_list(probe, device="cpu"))
    from repro.detection.map_engine import Detections as JDetections

    want = JOffloadEngine.load(out["engine_path"]).decide(
        [JDetections(d.boxes, d.scores, d.classes) for d in probe])
    np.testing.assert_allclose(got.estimates, np.asarray(want.estimates), atol=EST_TOL)


def small_lm(cfg):
    return dataclasses.replace(cfg, num_layers=2, d_model=64, num_heads=2, num_kv_heads=1,
                               head_dim=32, d_ff=128, vocab_size=256)


@pytest.mark.parametrize("arch", ["yi_6b", "rwkv6_1b6"])
def test_scaled_100m_equals_the_jax_scripts(arch):
    """The ~100M config, field by field, so that the checkpoint either
    package's ``train_lm`` writes loads in the other's ``serve_cascade``."""
    want = jax_script("train_lm").scaled_100m(arch)
    assert dataclasses.asdict(example("train_lm").scaled_100m(arch)) == dataclasses.asdict(want)


def test_lm_checkpoints_cross_both_ways(workdir, monkeypatch):
    """A ``repro``-written ``lm_100m.npz`` is served by the port's
    ``serve_cascade`` (its weak / strong NLL equal to ``repro``'s), and the
    port's ``train_lm`` writes one that ``repro``'s ``load_pytree`` reads
    bit for bit."""
    from repro.data.lm_synth import synth_lm_batch
    from repro.models.lm import init_params as j_init_params
    from repro.serving.cascade_serving import LMCascade as JLMCascade
    from repro.train.checkpoint import load_pytree as j_load_pytree
    from repro.train.checkpoint import save_pytree as j_save_pytree

    tl, sc = example("train_lm"), example("serve_cascade")
    real = tl.scaled_100m
    monkeypatch.setattr(tl, "scaled_100m", lambda arch: small_lm(real(arch)))
    jcfg = small_lm(jax_script("train_lm").scaled_100m("yi_6b"))
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    j_save_pytree(ex.artifact(tl.CKPT), jparams)

    out = sc.run("cpu", batch=4, seq=16, n_calib=2, epochs=2)
    assert out["loaded"] and out["decisions_identical"] and out["model"] == jcfg.name

    def mk(seed):
        toks, labels = synth_lm_batch(np.random.default_rng(seed), 4, 16, jcfg.vocab_size)
        return {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}

    jc = JLMCascade.fit(jparams, jcfg, exit_layer=1, calib_batches=[mk(1), mk(2)], ratio=0.25,
                        epochs=2)
    want = jc.serve_batch(jparams, mk(99))
    for got in out["ratios"].values():
        assert got["nll_weak"] == pytest.approx(float(want["nll_weak"].mean()), abs=LM_TOL)
        assert got["nll_strong"] == pytest.approx(float(want["nll_strong"].mean()), abs=LM_TOL)

    saved = {}
    real_save = tl.save_pytree

    def save(path, tree):
        saved["tree"] = tree
        real_save(path, tree)

    monkeypatch.setattr(tl, "save_pytree", save)
    trained = tl.run("cpu", steps=2, batch=2, seq=16)
    assert np.isfinite(trained["losses"]).all() and trained["ckpt"] == ex.artifact(tl.CKPT)
    loaded = j_load_pytree(trained["ckpt"], jparams)
    leaves = jax.tree_util.tree_leaves_with_path(loaded)
    assert len(leaves) == len(jax.tree.leaves(jparams))
    for path, leaf in leaves:
        node = saved["tree"]
        for k in path:
            node = node[k.key]
        assert np.asarray(leaf).dtype == np.float32
        np.testing.assert_array_equal(np.asarray(leaf), node.detach().numpy(), err_msg=str(path))


def test_fleet_scale_plane_bit_identical_on_four_cpu_shards(workdir):
    out = example("fleet_scale").run("cpu", n_rows=128, n_streams=64, n_ticks=8)
    assert out["plane"] == {"devices": 4, "bit_identical": True}
    city = out["city"]
    assert city["n_streams"] == 64 and len(city["hardness"]) == 4
    for arm in ("static", "coordinated"):
        assert 0.0 <= city[arm]["realized_ratio"] <= 1.0
