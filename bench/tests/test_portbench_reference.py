"""The plain references against the port on the CPU at a reduced width, in
float32: per-request NLL and reward features of both passes, the chunked
RWKV6 recurrence against the port's loop, and the decision stack against
the port's estimator and threshold policy."""
import numpy as np
import pytest
import torch

from portbench_util import tiny_model

from harness import traffic as tr
from harness.weights import make_params
from reference import common as ref
from reference import qwen2, rwkv6

FAMILIES = {"qwen2": qwen2, "rwkv6": rwkv6}


def _program(conf, seed):
    from repro_torch.models.lm import LMConfig, abstract_params

    cfg = LMConfig(**conf["model"])
    params = make_params(abstract_params(cfg), conf["init"], conf.get("float32_leaves", ()),
                         cfg.act_dtype, seed, torch.device("cpu"))
    return cfg, params


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_reference_matches_the_port(family):
    from repro_torch.api.features import logits_features
    from repro_torch.models.lm import forward
    from repro_torch.serving.cascade_serving import (sequence_nll, truncate_params,
                                                     truncated_config)

    conf = tiny_model(family)
    cfg, params = _program(conf, 11)
    exit_layer = conf["cascade"]["exit_layer"]
    rng = np.random.default_rng(5)
    toks, _ = tr.synth_lm_batch(rng, 3, 40, conf["model"]["vocab_size"])
    batch = tr.make_batch(list(toks), (40, 23, 31), 16)  # padded: the reference is not
    inputs = {"tokens": batch["tokens"], "labels": batch["labels"]}
    with torch.no_grad():
        wl, _ = forward(truncate_params(params, cfg, exit_layer),
                        truncated_config(cfg, exit_layer), inputs)
        sl, _ = forward(params, cfg, inputs)
        labels = torch.from_numpy(batch["labels"])
        prog = {"features": logits_features(wl, labels, 8).numpy(),
                "nll_weak": sequence_nll(wl, labels).numpy(),
                "nll_strong": sequence_nll(sl, labels).numpy()}
        seqs = [(batch["tokens"][i, :n], batch["labels"][i, :n])
                for i, n in enumerate(batch["lengths"])]
        res = ref.score(FAMILIES[family], params, conf["model"], exit_layer, seqs[:1], seqs, 8,
                        ref.exact)
    np.testing.assert_allclose(res["nll_weak"], prog["nll_weak"], atol=2e-5)
    np.testing.assert_allclose(res["nll_strong"], prog["nll_strong"], atol=2e-5)
    np.testing.assert_allclose(res["features"], prog["features"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(res["cal_features"], res["features"][:1])


@pytest.mark.parametrize("T", [1, 17, 64])
def test_chunked_recurrence_matches_the_ports_loop(T):
    from repro_torch.kernels.wkv6.ref import wkv6_ref

    g = torch.Generator().manual_seed(T)
    B, H, K, V = 2, 3, 8, 8
    r, k = (torch.randn(B, T, H, K, generator=g) for _ in range(2))
    v = torch.randn(B, T, H, V, generator=g)
    w = torch.rand(B, T, H, K, generator=g) * 0.5 + 0.499
    u = torch.randn(H, K, generator=g)
    s0 = torch.randn(B, H, K, V, generator=g)
    out, sT = rwkv6.wkv(r, k, v, torch.log(w), u, s0)
    want, want_s = wkv6_ref(*(t.double() for t in (r, k, v, w, u, s0)))
    np.testing.assert_allclose(out.double(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sT.double(), want_s, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("floor", [0.0, 2.0**-8])
def test_decision_stack_matches_the_port(floor):
    """Standardisation, the head and the threshold as the port's engine
    computes them (``estimator_mlp``'s plain version, ``ThresholdPolicy``);
    a feature that barely varies is divided by the floor's share of its
    mean."""
    from repro_torch.core.policy import ThresholdPolicy
    from repro_torch.kernels.estimator_mlp.ref import estimator_mlp_ref

    from drivers.lm_cascade import head_from_seed

    rng = np.random.default_rng(0)
    cal, sample = rng.normal(size=(40, 12)), rng.normal(size=(9, 12))
    cal[:, 0] = 11.0 + 1e-4 * cal[:, 0]
    sample[:, 0] = 11.0 + 1e-4 * sample[:, 0]
    head = head_from_seed(123, 12, 64)
    dec = ref.decisions(cal, sample, head, 0.25, floor)
    mu, sigma = ref.standardizer(cal, floor)
    if floor:
        assert sigma[0] == floor * abs(mu[0]) + 1e-6
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)  # noqa: E731
    est = estimator_mlp_ref(t((sample - mu) / sigma), t(head["w1"]), t(head["b1"]),
                            t(head["w2"]), t(head["b2"])).numpy()
    np.testing.assert_allclose(dec["estimates"], est, rtol=1e-12)
    scores = ref.mlp((cal - mu) / sigma, head)
    pol = ThresholdPolicy(scores, 0.25)
    assert dec["threshold"] == pol.threshold
    np.testing.assert_array_equal(dec["offload"], pol.decide_batch(est))


def test_fp8_control_rounds_coarser():
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(64, 64, generator=g), torch.randn(64, 64, generator=g)
    exact = ref.exact(a, b)
    err8 = (ref.fp8(a, b) - exact).abs().max()
    err16 = (a.bfloat16().float() @ b.bfloat16().float() - exact).abs().max()
    assert err8 > 4 * err16
