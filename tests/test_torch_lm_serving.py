"""The port's LM cascade serve path against the JAX package's, on the CPU:
``lm_logits`` features, ``sequence_nll``, and an engine fitted and saved by
``repro``'s ``LMCascade`` served by the port's ``LMCascade.load`` on the same
weights and batch (offload masks exactly equal), batch by batch
(``serve_batch``), as a stream through one session (``serve_stream``) and
session-gated decoding (``cascade_generate``, greedy tokens exactly equal),
plus the launcher (generate and ``--cascade``), for the dense, RWKV6, MoE
(with and without MLA) and VLM families; the MoE family's weak stack at
exit 1 is its dense layer and a MoE stack of length 0.  A VLM batch carries
a vision prefix and M-RoPE ids (``modality_fields``); ``cascade_generate``
refuses the ids (``repro``'s cuts them on the wrong axis) and serves the
batch without them.  The hybrid family has no cascade (in neither package)
and the launcher generates for it.  ``LMCascade.fit`` itself is held
against ``repro``'s in tests/test_torch_pipeline.py."""
import numpy as np
import pytest
import torch

from _torch_parity import modality_fields  # first: it imports repro.detection before repro's kernels
import jax
import jax.numpy as jnp
from repro.api.features import logits_features as j_logits_features
from repro.configs import get_config as j_get_config
from repro.models import lm as jlm
from repro.serving.cascade_serving import LMCascade as JLMCascade
from repro.serving.cascade_serving import sequence_nll as j_sequence_nll
from repro.serving.cascade_serving import truncate_params as j_truncate_params
from repro.serving.cascade_serving import truncated_config as j_truncated_config
from repro.serving.decode_loop import cascade_generate as j_cascade_generate

from repro_torch.api import LMLogitsFeatures, OffloadEngine, make_feature_extractor
from repro_torch.api.features import logits_features
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.data.lm_synth import synth_lm_batch
from repro_torch.launch import serve as launcher
from repro_torch.models import lm as tlm
from repro_torch.serving.cascade_serving import (
    LMCascade,
    sequence_nll,
    truncate_params,
    truncated_config,
)
from repro_torch.runtime import OffloadSession
from repro_torch.serving.decode_loop import cascade_generate, generate


def _logits_and_labels(seed, B=4, S=12, V=300, pad=3):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(0, 3, (B, S, V))).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[:, S - pad:] = -1
    labels[0] = -1  # a row with no valid position
    return logits, labels


@pytest.mark.parametrize("top_k", [8, 3])
@pytest.mark.parametrize("with_labels", [True, False])
def test_logits_features(top_k, with_labels):
    logits, labels = _logits_and_labels(top_k)
    lab = labels if with_labels else None
    want = j_logits_features(jnp.asarray(logits), None if lab is None else jnp.asarray(lab), top_k)
    got = logits_features(torch.from_numpy(logits), lab, top_k)
    assert got.shape == (4, 4 + top_k) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    fx = make_feature_extractor("lm_logits", top_k=top_k, device="cpu")
    assert isinstance(fx, LMLogitsFeatures) and fx.feature_dim == 4 + top_k
    np.testing.assert_allclose(fx({"logits": torch.from_numpy(logits), "labels": lab}).numpy(),
                               want, atol=1e-5)


def test_sequence_nll():
    logits, labels = _logits_and_labels(5)
    want = j_sequence_nll(jnp.asarray(logits), jnp.asarray(labels))
    got = sequence_nll(torch.from_numpy(logits), labels)
    assert got.shape == (4,) and float(got[0]) == 0.0  # no valid position
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _batch(seed, cfg, B=8, S=16):
    toks, labels = synth_lm_batch(np.random.default_rng(seed), B, S, cfg.vocab_size)
    return {"tokens": toks, "labels": labels, **modality_fields(cfg, B, S, seed)}


@pytest.fixture(scope="module", params=["qwen2_7b", "rwkv6_1b6", "deepseek_moe_16b",
                                        "deepseek_v2_lite_16b", "qwen2_vl_2b"])
def fitted(request, tmp_path_factory):
    """repro fits and saves an LMCascade; the port loads it and the weights."""
    arch = request.param
    jcfg = jlm.reduced(j_get_config(arch), num_layers=2)
    tcfg = tlm.reduced(get_config(arch), num_layers=2)
    tree = jax.tree.map(np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    jparams = jax.tree.map(jnp.asarray, tree)
    cal = {k: jnp.asarray(v) for k, v in _batch(1, jcfg, B=16).items()}
    jcascade = JLMCascade.fit(jparams, jcfg, exit_layer=1, calib_batches=[cal],
                              ratio=0.25, epochs=3)
    path = str(tmp_path_factory.mktemp(arch) / "lm_engine")
    jcascade.save(path)
    tcascade = LMCascade.load(path, tcfg, device="cpu")
    return jcascade, jparams, tcascade, lm_params_from_jax(tree, tcfg, device="cpu"), tcfg


def test_loaded_cascade_serves_like_repro(fitted):
    """Masks exactly equal, NLLs at 1e-5, and the decision stack isolated:
    the port's engine on repro's own weak-logit features gives repro's
    estimates at 1e-5.  End to end, the estimates are held at 1e-3: with
    untrained weights the logits are near uniform, the engine standardizes
    each feature by a sigma as small as ~3e-5, and the ~1e-6 float32
    difference of the two packages' log-softmax over the vocabulary (the
    features themselves agree at 1e-5, ``test_logits_features``) moves the
    MLP's input by up to ~4e-2."""
    jcascade, jparams, tcascade, tparams, tcfg = fitted
    assert tcascade.exit_layer == jcascade.exit_layer == 1
    assert tcascade.engine.reward_model.fused  # one hidden layer -> estimator_mlp
    for seed in (5, 6):
        batch = _batch(seed, tcfg)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        want = jcascade.serve_batch(jparams, jbatch)
        stage_ms = {}
        got = tcascade.serve_batch(tparams, batch, stage_ms=stage_ms)
        np.testing.assert_array_equal(got["offload"], want["offload"])
        for key in ("nll_weak", "nll_strong", "nll_final"):
            np.testing.assert_allclose(got[key], want[key], atol=1e-5, err_msg=key)
        np.testing.assert_allclose(got["estimates"], want["estimates"], atol=1e-3)
        assert got["offload_ratio"] == pytest.approx(want["offload_ratio"])
        assert set(stage_ms) == {"weak_forward_ms", "decide_ms", "nll_ms", "strong_forward_ms"}
        # the decision stack alone, on repro's features of repro's weak logits
        wlogits, _ = jlm.forward(j_truncate_params(jparams, jcascade.cfg, 1),
                                 j_truncated_config(jcascade.cfg, 1), jbatch)
        feats = np.asarray(j_logits_features(wlogits, jbatch["labels"]))
        jd = jcascade.engine.decide(features=feats)
        td = tcascade.engine.decide(features=feats)
        np.testing.assert_array_equal(td.offload, jd.offload)
        np.testing.assert_allclose(td.estimates, jd.estimates, atol=1e-5)


def test_cascade_views_and_ratio(fitted, tmp_path):
    jcascade, jparams, tcascade, tparams, tcfg = fitted
    assert tcascade.policy is tcascade.engine.policy
    assert tcascade.cdf is tcascade.engine.transform
    assert tcascade.estimator is tcascade.engine.reward_model.estimator
    batch = _batch(7, tcfg)
    tcascade.set_ratio(0.0)
    assert not tcascade.serve_batch(tparams, batch)["offload"].any()
    jcascade.set_ratio(1.0)
    tcascade.set_ratio(1.0)
    want = jcascade.serve_batch(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_array_equal(tcascade.serve_batch(tparams, batch)["offload"], want["offload"])
    # save from the port, load back: same decision stack
    tcascade.set_ratio(0.25)
    path = str(tmp_path / "again")
    tcascade.save(path)
    again = LMCascade.load(path, tcfg, device="cpu")
    np.testing.assert_array_equal(again.serve_batch(tparams, batch)["offload"],
                                  tcascade.serve_batch(tparams, batch)["offload"])
    assert isinstance(again.engine, OffloadEngine) and again.engine.extra_meta["exit_layer"] == 1


def test_unported_entry_points_raise(fitted):
    """The encoder-decoder and hybrid families have no early-exit cascade, in
    repro (its truncate_params knows neither) or here: the cascade's entry
    points raise ValueError for them, naming generate."""
    _, _, tcascade, tparams, tcfg = fitted
    batch = {k: v for k, v in _batch(5, tcfg).items() if k != "positions_3d"}
    encdec = tlm.reduced(get_config("whisper_base"), num_layers=2)
    encdec_cascade = LMCascade(cfg=encdec, exit_layer=1, engine=tcascade.engine)
    with pytest.raises(ValueError, match="encdec family is served by generate"):
        encdec_cascade.serve_stream(tparams, [batch])
    with pytest.raises(ValueError, match="encdec family is served by generate"):
        cascade_generate(tparams, encdec, batch, 4, exit_layer=1, engine=tcascade.engine)
    with pytest.raises(ValueError, match="encdec family is served by generate"):
        truncate_params(tparams, encdec, 1)
    hybrid = tlm.reduced(get_config("zamba2_2b7"))
    with pytest.raises(ValueError, match="hybrid family is served by generate"):
        LMCascade(cfg=hybrid, exit_layer=1, engine=tcascade.engine).serve_batch(tparams, batch)
    with pytest.raises(ValueError, match="engine= or session="):
        cascade_generate(tparams, tcfg, batch, 4, exit_layer=1)


def _same_stream(got, want):
    np.testing.assert_array_equal(got["offload"], want["offload"])
    for key in ("nll_weak", "nll_strong", "nll_final"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-5, err_msg=key)
    np.testing.assert_allclose(got["estimates"], want["estimates"], atol=1e-3)
    assert got["offload_ratio"] == want["offload_ratio"]
    g, w = dict(got["telemetry"]), dict(want["telemetry"])
    for key in ("mean_estimate", "reward_sum"):
        assert g.pop(key) == pytest.approx(w.pop(key), abs=1e-3), key
    assert g == w


@pytest.mark.parametrize("set_ratio_at", [None, {10: 0.75}])
def test_serve_stream_matches_repro(fitted, set_ratio_at):
    """Three batches of 8 through one session (micro-batch 8): repro's masks
    and telemetry counts (estimates and realized-reward sums at 1e-3, as
    ``test_loaded_cascade_serves_like_repro`` explains); a re-budget lands at
    the boundary before the batch holding its request; each batch's masks
    equal ``serve_batch``'s at the ratio in force."""
    jcascade, jparams, tcascade, tparams, tcfg = fitted
    batches = [_batch(20 + i, tcfg) for i in range(3)]
    jbatches = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    kw = dict(micro_batch=8, ratio=0.25, set_ratio_at=set_ratio_at)
    got = tcascade.serve_stream(tparams, batches, **kw)
    want = jcascade.serve_stream(jparams, jbatches, **kw)
    _same_stream(got, want)
    t = got["telemetry"]
    assert t["processed"] == 24 and t["offloaded"] == int(got["offload"].sum())
    assert t["rewards_recorded"] == t["offloaded"]
    ratios = [0.25, 0.25, 0.25] if set_ratio_at is None else [0.25, 0.75, 0.75]
    assert t["target_ratio"] == ratios[-1]
    for i, (b, r) in enumerate(zip(batches, ratios)):
        tcascade.set_ratio(r)
        single = tcascade.serve_batch(tparams, b)
        np.testing.assert_array_equal(got["offload"][8 * i: 8 * i + 8], single["offload"])
        np.testing.assert_array_equal(got["estimates"][8 * i: 8 * i + 8], single["estimates"])
    tcascade.set_ratio(0.25)
    # a long-lived session carries its state across calls
    session = OffloadSession(tcascade.engine, micro_batch=4)
    tcascade.serve_stream(tparams, batches[:1], session=session)
    again = tcascade.serve_stream(tparams, batches[1:2], session=session)
    assert again["telemetry"]["processed"] == 16
    assert tcascade.serve_stream(tparams, [])["offload"].shape == (0,)


def test_cascade_generate_matches_repro(fitted):
    """Greedy session-gated decoding: repro's masks and tokens exactly; each
    row's tokens are ``generate``'s on its stack over the same row subset.
    A VLM batch with M-RoPE ids raises (repro's call would cut the (3, B, S)
    ids on their first axis); without them it decodes as repro's does."""
    jcascade, jparams, tcascade, tparams, tcfg = fitted
    batch = _batch(31, tcfg)
    if "positions_3d" in batch:
        with pytest.raises(ValueError, match="positions_3d"):
            cascade_generate(tparams, tcfg, batch, 6, engine=tcascade.engine, exit_layer=1)
        del batch["positions_3d"]
    tcascade.set_ratio(0.5)
    jcascade.set_ratio(0.5)
    try:
        got = cascade_generate(tparams, tcfg, batch, 6, engine=tcascade.engine, exit_layer=1)
        want = j_cascade_generate(jparams, jcascade.cfg, {k: jnp.asarray(v) for k, v in batch.items()},
                                  6, engine=jcascade.engine, exit_layer=1)
    finally:
        tcascade.set_ratio(0.25)
        jcascade.set_ratio(0.25)
    offload = got["offload"]
    np.testing.assert_array_equal(offload, want["offload"])
    assert 0 < offload.sum() < len(offload)
    assert got["tokens"].dtype == torch.int32 and got["tokens"].shape == (8, 6)
    np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])
    np.testing.assert_allclose(got["estimates"], want["estimates"], atol=1e-3)
    assert got["offload_ratio"] == want["offload_ratio"]
    assert got["telemetry"]["processed"] == 8
    wparams = truncate_params(tparams, tcfg, 1)
    for p, c, rows in ((wparams, truncated_config(tcfg, 1), np.flatnonzero(~offload)),
                       (tparams, tcfg, np.flatnonzero(offload))):
        sub = {k: torch.as_tensor(v)[torch.from_numpy(rows)] for k, v in batch.items()}
        np.testing.assert_array_equal(got["tokens"][rows].numpy(), generate(p, c, sub, 6).numpy())
    # sampling draws from the caller's generator: the same seed, the same tokens
    draws = [cascade_generate(tparams, tcfg, batch, 4, engine=tcascade.engine, exit_layer=1,
                              greedy=False, generator=torch.Generator().manual_seed(3))["tokens"]
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    assert int(draws[0].min()) >= 0 and int(draws[0].max()) < tcfg.vocab_size


@pytest.mark.parametrize("arch", ["qwen2_7b", "rwkv6_1b6", "deepseek_moe_16b", "deepseek_v2_lite_16b",
                                  "qwen2_vl_2b", "zamba2_2b7", "whisper_base"])
def test_launcher_on_cpu(arch, capsys):
    out = launcher.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                         "--prompt-len", "8", "--tokens", "4"])
    assert out.shape == (2, 4)
    assert "generated (2, 4) on cpu" in capsys.readouterr().out
    out = launcher.main(["--arch", arch, "--device", "cpu", "--cascade"])
    if arch in ("zamba2_2b7", "whisper_base"):  # no cascade for these, as in repro: they generate
        assert out.shape == (8, 16) and "generated (8, 16) on cpu" in capsys.readouterr().out
        return
    assert out["offload"].shape == (8,) and 0 < out["offload"].sum() < 8
    assert np.isfinite(out["nll_final"]).all()
    assert capsys.readouterr().out.startswith("cascade: offload_ratio=")


def test_launcher_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works here")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        launcher.main(["--arch", "qwen2_7b"])
