"""The port's fitting entry points against ``repro``'s on the CPU:
``OffloadEngine.fit`` (MLP and CNN reward models), ``LMCascade.fit``, and a
tiny ``build_pipeline`` + ``build_engine``.

Both packages start the estimator from ``repro``'s initial weights (the
port's ``mlp_init`` is replaced in the test by one that returns them).
Tolerances: fitted estimates at 1e-4 (float32 training, see
tests/test_torch_train.py), the LM path's features and rewards at 1e-5 and
its estimates at 1e-3 (as tests/test_torch_lm_serving.py holds them), mAPs
at 1e-4.  NMS keeps, ``tp`` / ``match_gt`` and decisions are exact."""
import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401  (pipelines, repro_init: shared fixtures)
    both_detections,
    detector_like,
    pipelines,
    random_detection_arrays,
    repro_init,
    modality_fields,
)

import repro.detection.batch  # noqa: F401  (first: repro's kernels import it back)
import jax
import jax.numpy as jnp
import repro.api as japi
import repro.experiments.detection_repro as jdr
from repro.configs import get_config as j_get_config
from repro.core import estimator as jest
from repro.detection.batch import DetectionsBatch as JDB
from repro.models import lm as jlm
from repro.serving.cascade_serving import LMCascade as JLMCascade

import repro_torch.experiments.detection_repro as tdr
from repro_torch.api import CNNRewardModel, MLPRewardModel, OffloadEngine
from repro_torch.api.features import DetectionBoxFeatures
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.core import estimator as port_est
from repro_torch.data.lm_synth import synth_lm_batch
from repro_torch.detection.batch import DetectionsBatch as TDB
from repro_torch.models import lm as tlm
from repro_torch.serving.cascade_serving import LMCascade
from repro_torch.train.checkpoint import load_pytree

NUM_CLASSES, TOP_K, SIZE = 8, 25, 64.0


def near_threshold(est, policy, tol):
    return np.abs(np.asarray(est) - policy.threshold) <= tol


# ----------------------------------------------------------- OffloadEngine


@pytest.mark.parametrize("transform,epochs", [("cdf", 4), (None, 2)])
def test_offload_engine_fit_equals_repro(repro_init, transform, epochs, tmp_path):
    rng = np.random.default_rng(epochs)
    jd, td = both_detections(random_detection_arrays(rng, 300, 40, NUM_CLASSES, scale=SIZE))
    rewards = rng.normal(0, 1, 300) * (rng.uniform(0, 1, 300) < 0.6)
    cfg = dict(hidden=(64,), epochs=epochs, batch_size=64)
    jeng = japi.OffloadEngine(
        feature_extractor=japi.DetectionBoxFeatures(NUM_CLASSES, TOP_K, image_size=SIZE),
        reward_model=japi.MLPRewardModel(config=jest.EstimatorConfig(**cfg)),
        transform=transform, ratio=0.3).fit(JDB.from_list(jd), rewards)
    teng = OffloadEngine(
        feature_extractor=DetectionBoxFeatures(NUM_CLASSES, TOP_K, image_size=SIZE, device="cpu"),
        reward_model=MLPRewardModel(config=port_est.EstimatorConfig(**cfg), device="cpu"),
        transform=transform, ratio=0.3, device="cpu").fit(TDB.from_list(td, device="cpu"), rewards)
    assert teng.reward_model.fused
    np.testing.assert_allclose(teng.calibration_scores, jeng.calibration_scores, atol=1e-4)
    if transform:
        np.testing.assert_array_equal(teng.transform.state()["sorted_rewards"],
                                      jeng.transform.state()["sorted_rewards"])
    # decisions on new requests, and the policy's ordering of the calibration set
    req_j, req_t = both_detections(random_detection_arrays(np.random.default_rng(9), 64, 40,
                                                           NUM_CLASSES, scale=SIZE))
    want, got = jeng.decide(JDB.from_list(req_j)), teng.decide(TDB.from_list(req_t, device="cpu"))
    near = near_threshold(want.estimates, jeng.policy, 1e-4)
    np.testing.assert_array_equal(got.offload[~near], want.offload[~near])
    assert not near.any() and 0 < want.offload.sum() < 64
    order = np.argsort(-jeng.calibration_scores, kind="stable")[:60]
    assert np.mean(np.isin(order, np.argsort(-teng.calibration_scores, kind="stable")[:60])) > 0.95
    # the port's fitted artifact loads in repro and decides as the port does
    path = str(tmp_path / "fitted")
    teng.save(path)
    back = japi.OffloadEngine.load(path)
    np.testing.assert_array_equal(back.decide(JDB.from_list(req_j)).offload, got.offload)


def test_engine_fit_needs_rewards():
    eng = OffloadEngine(device="cpu")
    with pytest.raises(ValueError, match="rewards"):
        eng.fit(features=np.zeros((4, 3), np.float32))


def test_cnn_reward_model_behind_engine(tmp_path):
    """The §V-A feature-map CNN fits behind the same engine contract, and
    its artifact loads in repro with the same estimates."""
    rng = np.random.default_rng(0)
    fmaps = rng.normal(0, 1, (64, 8, 8, 4)).astype(np.float32)
    rewards = fmaps.mean(axis=(1, 2, 3))
    eng = OffloadEngine(reward_model=CNNRewardModel(epochs=2, batch_size=32, device="cpu"),
                        ratio=0.25, device="cpu")
    eng.fit(features=fmaps, rewards=rewards)
    assert not eng.reward_model.fused
    scores = eng.score(features=fmaps)
    assert scores.shape == (64,) and np.isfinite(scores).all()
    assert 0.0 <= eng.decide(features=fmaps).ratio <= 1.0
    path = str(tmp_path / "cnn_engine")
    eng.save(path)
    back = japi.OffloadEngine.load(path)
    np.testing.assert_allclose(back.score(features=fmaps), scores, atol=1e-6)
    again = OffloadEngine.load(path, device="cpu")
    np.testing.assert_array_equal(again.decide(features=fmaps).offload,
                                  eng.decide(features=fmaps).offload)


# ------------------------------------------------------------- LMCascade


def _lm_batch(seed, cfg, B=16, S=16):
    toks, labels = synth_lm_batch(np.random.default_rng(seed), B, S, cfg.vocab_size)
    return {"tokens": toks, "labels": labels, **modality_fields(cfg, B, S, seed)}


@pytest.mark.parametrize("arch", ["qwen2_7b", "rwkv6_1b6", "deepseek_moe_16b", "deepseek_v2_lite_16b",
                                  "qwen2_vl_2b"])
def test_lm_cascade_fit_equals_repro(repro_init, arch):
    """Two calibration batches: rewards (NLL_weak - NLL_strong) and the
    features' standardize statistics at 1e-5, calibration estimates at 1e-3
    (an engine on untrained weights standardizes by sigmas near 3e-5, so
    ~1e-6 float32 differences in the features move estimates by ~1e-4),
    decisions equal wherever the estimate is not within 1e-3 of the
    threshold.  The MoE family runs 3 layers with the exit at 2, so that
    the weak stack holds a MoE layer after its dense one."""
    layers, exit_layer = (3, 2) if arch.startswith("deepseek") else (2, 1)
    jcfg = jlm.reduced(j_get_config(arch), num_layers=layers)
    tcfg = tlm.reduced(get_config(arch), num_layers=layers)
    tree = jax.tree.map(np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = lm_params_from_jax(tree, tcfg, device="cpu")
    cals = [_lm_batch(s, jcfg) for s in (1, 2)]
    jc = JLMCascade.fit(jparams, jcfg, exit_layer,
                        [{k: jnp.asarray(v) for k, v in b.items()} for b in cals], ratio=0.25, epochs=3)
    tc = LMCascade.fit(tparams, tcfg, exit_layer,
                       [{k: torch.from_numpy(v) for k, v in b.items()} for b in cals],
                       ratio=0.25, epochs=3)
    assert tc.exit_layer == exit_layer and tc.engine.reward_model.fused
    assert tc.engine.reward_model.config.hidden == (64,)
    np.testing.assert_allclose(tc.cdf.state()["sorted_rewards"], jc.cdf.state()["sorted_rewards"],
                               atol=1e-5)
    np.testing.assert_allclose(tc.estimator._mu, jc.estimator._mu, atol=1e-5)
    np.testing.assert_allclose(tc.estimator._sigma, jc.estimator._sigma, atol=1e-5)
    np.testing.assert_allclose(tc.engine.calibration_scores, jc.engine.calibration_scores, atol=1e-3)
    batch = _lm_batch(5, tcfg, B=8)
    want = jc.serve_batch(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    got = tc.serve_batch(tparams, batch)
    near = near_threshold(want["estimates"], jc.policy, 1e-3)
    np.testing.assert_array_equal(got["offload"][~near], want["offload"][~near])
    for key in ("nll_weak", "nll_strong"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-5, err_msg=key)


# --------------------------------------------------------------- pipeline


def _same_evals(got, want):
    assert got.gt_counts == want.gt_counts
    assert sorted(got.per_class) == sorted(want.per_class)
    for c in want.per_class:
        np.testing.assert_allclose(got.per_class[c][0], want.per_class[c][0], atol=1e-5)
        np.testing.assert_array_equal(got.per_class[c][1], want.per_class[c][1])  # tp
        np.testing.assert_array_equal(got.matched_gt[c], want.matched_gt[c])


def test_build_pipeline_equals_repro(pipelines):
    jstate, tstate, stage, tdir = pipelines
    assert set(stage) == {"data_ms", "train_weak_ms", "train_strong_ms", "decode_ms", "match_ms",
                          "map_ms", "features_ms"}
    assert {k: len(v) for k, v in tstate.train_losses.items()} == {"weak": 3, "strong": 3}
    for name in ("weak", "strong"):
        cfg = jdr.WEAK if name == "weak" else jdr.STRONG
        got = load_pytree(str(tdir / f"torch_detector_{name}.npz"),
                          jax.tree.map(lambda a: torch.zeros(a.shape), detector_like(cfg)))
        assert got["head_out"]["b"][0] == 3.0  # the port wrote the weights it scored with
    n_dets = 0
    for dets in ("weak_dets_val", "strong_dets_val"):
        for g, w in zip(getattr(tstate, dets), getattr(jstate, dets)):
            assert len(g) == len(w)  # the NMS keeps
            np.testing.assert_array_equal(g.classes, w.classes)
            np.testing.assert_allclose(g.boxes / SIZE, w.boxes / SIZE, atol=1e-5)
            np.testing.assert_allclose(g.scores, w.scores, atol=1e-5)
            n_dets += len(w)
    assert n_dets > 64
    for g, w in zip(tstate.val_pairs, jstate.val_pairs):
        _same_evals(g.weak, w.weak)
        _same_evals(g.strong, w.strong)
    for g, w in zip(tstate.pool_weak_evals, jstate.pool_weak_evals):
        _same_evals(g, w)
    assert len(tstate.val_pairs) == len(tstate.pool_weak_evals) == 64
    assert abs(tstate.weak_map - jstate.weak_map) <= 1e-4
    assert abs(tstate.strong_map - jstate.strong_map) <= 1e-4
    np.testing.assert_allclose(tstate.features_val, jstate.features_val, atol=1e-5)
    # the cache is the port's own file; a second call reads it
    again = tdr.build_pipeline(device="cpu", cache_dir=str(tdir), verbose=False)
    assert again.weak_map == tstate.weak_map


def test_build_engine_equals_repro(pipelines, repro_init):
    jstate, tstate, _, _ = pipelines
    jeng = jdr.build_engine(jstate, context_size=32, epochs=3)
    teng = tdr.build_engine(tstate, context_size=32, epochs=3, device="cpu")
    assert teng.reward_model.fused and teng.ratio == jeng.ratio == 0.2
    np.testing.assert_array_equal(teng.transform.state()["sorted_rewards"],
                                  jeng.transform.state()["sorted_rewards"])
    np.testing.assert_allclose(teng.calibration_scores, jeng.calibration_scores, atol=1e-4)
    got, want = teng.decide(tstate.weak_dets_val), jeng.decide(jstate.weak_dets_val)
    np.testing.assert_array_equal(got.offload, want.offload)
    assert 0 < want.offload.sum() < len(want.offload)
