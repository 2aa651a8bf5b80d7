"""The encoder-decoder family (whisper-base) in the port against the JAX
package's, layer by layer, on the CPU: the GELU MLP, the sinusoid positions,
bidirectional attention, the encoder and the two cross-attentions; the
decode cache; and the ``flash_sdpa`` routes whisper-base's attention takes
on the card at its full widths.  The whole model (forward, prefill and
decode, greedy generate, the ring cache, training and the launchers) is in
``tests/test_torch_lm*.py``.

Weights are ``repro``'s draw, perturbed from numpy (``perturbed``) so that
biases and norm scales are not trivially 0 or 1, carried into the port by
``lm_params_from_jax``.  Float32 layers compare at 1e-5, the sinusoids at
1e-6."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import modality_fields, perturbed  # first: it imports repro.detection before repro's kernels
import jax
import jax.numpy as jnp
from repro.configs import get_config as j_get_config
from repro.models import layers as jl
from repro.models import lm as jlm

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels.flash_sdpa.ops import decode_plan, flash_route
from repro_torch.models import layers as tl
from repro_torch.models import lm as tlm

B, S = 2, 16


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


@pytest.fixture(scope="module")
def whisper():
    """(repro cfg, repro params, port cfg, port params, numpy batch) of the
    reduced whisper-base: 2 + 2 layers, d 128, 32 frames, float32."""
    jcfg, tcfg = jlm.reduced(j_get_config("whisper_base")), tlm.reduced(get_config("whisper_base"))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert (tcfg.encoder_layers, tcfg.num_layers, tcfg.d_model, tcfg.encoder_frames) == (2, 2, 128, 32)
    tree = perturbed(jax.jit(jlm.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(40)), 440)
    toks = np.random.default_rng(40).integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": toks, **modality_fields(tcfg, B, S, 40)}
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg, lm_params_from_jax(tree, tcfg, device="cpu"),
            batch)


def layer(params, stack, i=0):
    return tlm.layer_params(params[stack], i)


def jlayer(params, stack, i=0):
    return jax.tree.map(lambda a: a[i], params[stack])


# ------------------------------------------------------------------ layers


def test_gelu_mlp():
    """Biased projections around GELU's tanh approximation (jax.nn.gelu's
    default), which the exact erf form would miss by more than 1e-5."""
    tree = perturbed(jl.gelu_mlp_init(jax.random.PRNGKey(41), 64, 96), 41, scale=0.1)
    x = np.random.default_rng(41).normal(0, 2, (B, S, 64)).astype(np.float32)
    want = jl.gelu_mlp(tree, jnp.asarray(x))
    tparams = jax.tree.map(t, tree)
    close(tl.gelu_mlp(tparams, t(x)), want)
    h = t(x) @ tparams["up"] + tparams["up_b"]
    exact = torch.nn.functional.gelu(h) @ tparams["down"] + tparams["down_b"]
    assert float((exact - torch.from_numpy(np.array(want))).abs().max()) > 1e-4
    init = tl.gelu_mlp_init(torch.Generator().manual_seed(0), 64, 96, stack=3)
    assert {k: tuple(v.shape) for k, v in init.items()} == {
        "up": (3, 64, 96), "up_b": (3, 96), "down": (3, 96, 64), "down_b": (3, 64)}
    assert not init["up_b"].any() and not init["down_b"].any()


@pytest.mark.parametrize("n,d", [(32, 128), (1500, 512), (4096, 512)])
def test_sinusoid(n, d):
    got = tlm._sinusoid(n, d, torch.float32)
    assert got.shape == (n, d)
    close(got, jlm._sinusoid(n, d, jnp.float32), 1e-6)
    assert tlm._sinusoid(n, d, torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("pos", [0, 7, 1499, 4000])
def test_sinusoid_at(pos):
    got = tlm._sinusoid_at(pos, 512, torch.float32)
    close(got, jlm._sinusoid_at(jnp.asarray(pos, jnp.int32), 512, jnp.float32), 1e-6)
    assert torch.equal(got, tlm._sinusoid(pos + 1, 512, torch.float32)[pos])


@pytest.mark.parametrize("S_,kv", [(16, 4), (37, 2)])
def test_bidirectional_attention(S_, kv):
    """attention_apply(causal=False) against repro's under an all-ones mask
    (the whisper encoder's), MHA and GQA; a window in the config is not
    applied, as repro's explicit mask ignores it."""
    jcfg = jl.AttnConfig(d_model=64, num_heads=4, num_kv_heads=kv, head_dim=32, use_rope=False,
                         window=4)
    tcfg = tl.AttnConfig(**{f: getattr(jcfg, f) for f in tl.AttnConfig._fields})
    tree = perturbed(jl.attention_init(jax.random.PRNGKey(42), jcfg), 42)
    x = np.random.default_rng(S_).normal(0, 1, (B, S_, 64)).astype(np.float32)
    want = jl.attention_apply(tree, jcfg, jnp.asarray(x), None, None, mask=jnp.ones((1, S_, S_), bool))
    tparams = jax.tree.map(t, tree)
    close(tl.attention_apply(tparams, tcfg, t(x), None, causal=False), want)
    close(tl.attention_apply(tparams, tcfg, t(x), None, causal=False, plain=True), want)
    causal = tl.attention_apply(tparams, tcfg, t(x), None)
    assert float((causal - torch.from_numpy(np.array(want))).abs().max()) > 1e-3


def test_non_causal_attention_takes_no_window():
    q = torch.zeros(1, 4, 2, 32)
    with pytest.raises(ValueError, match="no window"):
        tl._sdpa(q, q, q, window=4, q_offset=0, causal=False)


# ------------------------------------------------------------------ encoder, cross-attention


def test_encode(whisper):
    jcfg, jparams, tcfg, tparams, batch = whisper
    want = jlm._encode(jparams, jcfg, {"audio_frames": jnp.asarray(batch["audio_frames"])})
    got = tlm._encode(tparams, tcfg, batch)
    assert got.shape == (B, tcfg.encoder_frames, tcfg.d_model)
    close(got, want)
    close(tlm._encode(tparams, tcfg, batch, plain=True), want)


def test_cross_attention(whisper):
    """q from the decoder's activations (S 16), k / v from the encoder's (32
    frames): no mask, no window."""
    jcfg, jparams, tcfg, tparams, batch = whisper
    rng = np.random.default_rng(43)
    x = rng.normal(0, 1, (B, S, tcfg.d_model)).astype(np.float32)
    enc = rng.normal(0, 1, (B, tcfg.encoder_frames, tcfg.d_model)).astype(np.float32)
    ap, jap = layer(tparams, "dec_layers", 1)["cross_attn"], jlayer(jparams, "dec_layers", 1)["cross_attn"]
    want = jlm._cross_attention(jap, jcfg, jnp.asarray(x), jnp.asarray(enc),
                                jnp.ones((1, S, tcfg.encoder_frames), bool))
    close(tlm._cross_attention(ap, tcfg, t(x), t(enc)), want)
    close(tlm._cross_attention(ap, tcfg, t(x), t(enc), plain=True), want)


@pytest.mark.parametrize("S_", [1, 5])
def test_cross_attention_cached(whisper, S_):
    """Against the cache's k / v: a decode step's one query (S 1) and a few."""
    jcfg, jparams, tcfg, tparams, batch = whisper
    rng = np.random.default_rng(44 + S_)
    x = rng.normal(0, 1, (B, S_, tcfg.d_model)).astype(np.float32)
    kv = (B, tcfg.encoder_frames, tcfg.num_kv_heads, tcfg.head_dim)
    xk, xv = rng.normal(0, 1, kv).astype(np.float32), rng.normal(0, 1, kv).astype(np.float32)
    ap, jap = layer(tparams, "dec_layers")["cross_attn"], jlayer(jparams, "dec_layers")["cross_attn"]
    want = jlm._cross_attention_cached(jap, jcfg, jnp.asarray(x), jnp.asarray(xk), jnp.asarray(xv),
                                       jnp.ones((1, S_, tcfg.encoder_frames), bool))
    close(tlm._cross_attention_cached(ap, tcfg, t(x), t(xk), t(xv)), want)


def test_prefill_cross_cache_is_the_cross_attention_kv(whisper):
    """prefill's xk / xv are the encoder output through each layer's wk /
    wv, bit for bit what its cross-attention attended over."""
    _, _, tcfg, tparams, batch = whisper
    _, cache = tlm.prefill(tparams, tcfg, batch, capacity=S + 2)
    enc = tlm._encode(tparams, tcfg, batch)
    for i in range(tcfg.num_layers):
        k, v = tlm._cross_kv(layer(tparams, "dec_layers", i)["cross_attn"], tcfg, enc)
        assert torch.equal(cache["xk"][i], k) and torch.equal(cache["xv"][i], v)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_init_cache_matches_repro_and_ignores_kv_quant(kv_quant):
    jcfg = dataclasses.replace(j_get_config("whisper_base"), kv_quant=kv_quant)
    tcfg = dataclasses.replace(get_config("whisper_base"), kv_quant=kv_quant)
    want = jlm.init_cache(jcfg, 8, 528, abstract=True)
    got = tlm.init_cache(tcfg, 8, 528, device="meta")
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in got.items()} == {
        k: (tuple(v.shape), "torch." + str(v.dtype)) for k, v in want.items()}
    assert got["xk"].shape == (6, 8, 1500, 8, 64) and got["k"].dtype == torch.bfloat16


def test_remat_recomputes_each_encoder_and_decoder_layer(whisper, monkeypatch):
    _, _, tcfg, tparams, batch = whisper
    params = tlm.tree_map(lambda a: a.detach().requires_grad_(), tparams)
    calls = []
    apply = tlm.attention_apply
    monkeypatch.setattr(tlm, "attention_apply", lambda *a, **k: calls.append(k.get("causal", True))
                        or apply(*a, **k))
    with torch.enable_grad():
        loss = tlm.loss_fn(params, tcfg, {**batch, "labels": batch["tokens"]})
        torch.autograd.grad(loss, list(tlm.tree_leaves(params)))
    # forward + recompute: the encoder's bidirectional, the decoder's causal self-attention
    assert calls.count(False) == 2 * tcfg.encoder_layers
    assert calls.count(True) == 2 * tcfg.num_layers


# ------------------------------------------------------------------ flash_sdpa at whisper-base


def test_whisper_base_attention_routes():
    """At whisper-base's widths (8 / 8 heads, D 64, bf16) the encoder (S = T
    = 1500), the decoder's prefill self- and cross-attention (S 512) take
    the wgmma route and a decode step's self- and cross-attention (S 1) the
    decode route; the non-causal decode step reads every one of the 1500
    frames, whatever q_offset says."""
    cfg = get_config("whisper_base")
    G = cfg.num_heads // cfg.num_kv_heads
    assert (cfg.num_heads, G, cfg.head_dim, cfg.encoder_frames) == (8, 1, 64, 1500)
    for S_ in (1500, 512):
        assert flash_route(torch.bfloat16, S_, cfg.head_dim, G) == "wgmma"
    assert flash_route(torch.bfloat16, 1, cfg.head_dim, G) == "decode"
    for q_offset in (0, 512, 4000):
        plan = decode_plan(8, 1, 1500, 8, 8, 64, False, 0, q_offset)
        assert (plan.kbeg, plan.kend, plan.tiles, plan.rows) == (0, 1500, 47, 1)
        assert (plan.splits - 1) * plan.tiles_per_split < plan.tiles <= plan.splits * plan.tiles_per_split
