"""The port's LM layers and models against the JAX package's, on the CPU.

Weights are drawn by ``repro`` (then perturbed from numpy, so that biases,
norm scales, qk-norm, the RWKV6 bonus and decay base are not trivially 0 or
1), and carried into the port by ``lm_params_from_jax``.  Float32 layers
compare at 1e-5, the reference's own kernel tolerance; greedy tokens must be
equal.  The hybrid's SSM state (entries up to ~12) is held at 1e-5 of its
largest entry: a float32 sum of decayed terms whose inputs already differ
by the two frameworks' matmul roundings.  The VLM batch carries a vision
prefix and M-RoPE ids with distinct t / h / w (a grid on the prefix), the
encoder-decoder batch seeded audio frames (``modality_fields``)."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import modality_fields  # first: it imports repro.detection before repro's kernels
import jax
import jax.numpy as jnp
from repro.configs import get_config as j_get_config
from repro.models import layers as jl
from repro.models import lm as jlm
from repro.serving.decode_loop import generate as j_generate

from repro_torch.configs import all_configs, get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import layers as tl
from repro_torch.models import lm as tlm
from repro_torch.serving.cascade_serving import truncate_params, truncated_config
from repro_torch.serving.decode_loop import generate

ARCHS = ["qwen2_7b", "yi_6b", "qwen3_14b", "qwen1_5_32b", "rwkv6_1b6", "deepseek_moe_16b",
         "deepseek_v2_lite_16b", "qwen2_vl_2b", "zamba2_2b7", "whisper_base"]
B, S = 2, 16


def lm_batch(cfg, toks, seed=0):
    """The tokens, and for the VLM family a seeded vision prefix and M-RoPE
    ids, for the encoder-decoder its audio frames (``modality_fields``)."""
    return {"tokens": toks, **modality_fields(cfg, *toks.shape, seed)}


def cache_tol(name, want):
    return 1e-5 * max(1.0, float(np.abs(np.asarray(want)).max())) if name == "ssm" else 1e-5


def perturbed(tree, seed, scale=0.05):
    """numpy copy of a JAX pytree with N(0, scale) added to every leaf."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a, np.float32) + rng.normal(0, scale, a.shape)).astype(np.float32),
        tree,
    )


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), atol=atol)


# ------------------------------------------------------------------ layers


def test_rmsnorm_and_layernorm():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (2, 5, 64)).astype(np.float32)
    p = {"scale": rng.normal(1, 0.1, 64).astype(np.float32)}
    close(tl.rmsnorm({"scale": t(p["scale"])}, t(x)), jl.rmsnorm(p, jnp.asarray(x)))
    p["bias"] = rng.normal(0, 0.1, 64).astype(np.float32)
    close(tl.layernorm({k: t(v) for k, v in p.items()}, t(x)), jl.layernorm(p, jnp.asarray(x)))


@pytest.mark.parametrize("theta", [1e6, 5e6, 1e4])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 24, 3, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24)[None], (2, 24))
    close(tl.rope_freqs(32, theta), jl.rope_freqs(32, theta), atol=1e-7)
    close(tl.apply_rope(t(x), torch.from_numpy(pos.copy()), theta),
          jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("sections,D", [((4, 6, 6), 32), ((16, 24, 24), 128)])
def test_apply_mrope(sections, D):
    """Distinct t / h / w ids, so that each band's axis matters (equal ids
    are 1-D RoPE, which the port also checks against its own apply_rope)."""
    rng = np.random.default_rng(D)
    x = rng.normal(0, 1, (2, 24, 3, D)).astype(np.float32)
    p3d = rng.integers(0, 40, (3, 2, 24)).astype(np.int32)
    want = jl.apply_mrope(jnp.asarray(x), jnp.asarray(p3d), sections, 1e6)
    got = tl.apply_mrope(t(x), torch.from_numpy(p3d), sections, 1e6)
    close(got, want)
    flat = np.broadcast_to(p3d[:1], p3d.shape).copy()
    assert torch.equal(tl.apply_mrope(t(x), torch.from_numpy(flat), sections),
                       tl.apply_rope(t(x), torch.from_numpy(flat[0])))
    assert not np.allclose(got.numpy(), tl.apply_rope(t(x), torch.from_numpy(p3d[0])).numpy())


@pytest.mark.parametrize("S_", [1, 16, 37, 64])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_apply(S_, with_state):
    """Outputs, SSM and conv states at 1e-5, with and without incoming
    states; chunks of 16 (S = 37: a short last chunk; S = 1: the single
    step)."""
    jcfg = jl.Mamba2Config(d_model=64, d_state=16, head_dim=16)
    tcfg = tl.Mamba2Config(**jcfg._asdict())
    tree = perturbed(jl.mamba2_init(jax.random.PRNGKey(13), jcfg), 13)
    tparams = jax.tree.map(t, tree)
    rng = np.random.default_rng(S_)
    x = rng.normal(0, 1, (B, S_, 64)).astype(np.float32)
    st = cv = None
    if with_state:
        st = rng.normal(0, 0.3, (B, jcfg.num_heads, 16, 16)).astype(np.float32)
        cv = rng.normal(0, 1, (B, jcfg.conv_width - 1, jcfg.d_inner + 32)).astype(np.float32)
    want = jl.mamba2_apply(tree, jcfg, jnp.asarray(x), None if st is None else jnp.asarray(st),
                           None if cv is None else jnp.asarray(cv), chunk=16)
    got = tl.mamba2_apply(tparams, tcfg, t(x), None if st is None else t(st),
                          None if cv is None else t(cv), chunk=16)
    assert got[1].dtype == torch.float32 and got[1].shape == (B, jcfg.num_heads, 16, 16)
    for g, w in zip(got, want):
        close(g, w)


ATTN = {  # (qkv_bias, qk_norm, num_kv_heads): qwen2 / yi / qwen3 attention
    "qwen2": (True, False, 2),
    "yi": (False, False, 2),
    "qwen3": (False, True, 2),
    "mha": (True, True, 4),
}


def _attn(kind, seed=0):
    bias, qk_norm, kv = ATTN[kind]
    jcfg = jl.AttnConfig(d_model=64, num_heads=4, num_kv_heads=kv, head_dim=32,
                         qkv_bias=bias, qk_norm=qk_norm, rope_theta=1e4)
    tcfg = tl.AttnConfig(**{f: getattr(jcfg, f) for f in tl.AttnConfig._fields})
    tree = perturbed(jl.attention_init(jax.random.PRNGKey(seed), jcfg), seed)
    tparams = jax.tree.map(t, tree)
    return jcfg, tcfg, tree, tparams


@pytest.mark.parametrize("kind", list(ATTN))
def test_attention_apply(kind):
    jcfg, tcfg, tree, tparams = _attn(kind)
    x = np.random.default_rng(2).normal(0, 1, (B, S, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).copy()
    want, (wk, wv) = jl.attention_apply(tree, jcfg, jnp.asarray(x), jnp.asarray(pos), return_kv=True)
    got, (gk, gv) = tl.attention_apply(tparams, tcfg, t(x), torch.from_numpy(pos), return_kv=True)
    close(got, want)
    close(gk, wk)
    close(gv, wv)
    close(tl.attention_apply(tparams, tcfg, t(x), torch.from_numpy(pos), plain=True), want)


@pytest.mark.parametrize("kind", list(ATTN))
@pytest.mark.parametrize("pos", [0, 9])
def test_attention_decode(kind, pos):
    """Against repro's ``attention_decode``, whose finfo.min mask sees the
    same slots 0..pos: at pos = 0 only the token itself."""
    jcfg, tcfg, tree, tparams = _attn(kind, seed=3)
    rng = np.random.default_rng(4 + pos)
    C = 12
    x = rng.normal(0, 1, (B, 1, 64)).astype(np.float32)
    ck = rng.normal(0, 1, (B, C, jcfg.num_kv_heads, 32)).astype(np.float32)
    cv = rng.normal(0, 1, (B, C, jcfg.num_kv_heads, 32)).astype(np.float32)
    want, wk, wv = jl.attention_decode(tree, jcfg, jnp.asarray(x), jnp.asarray(ck),
                                       jnp.asarray(cv), jnp.asarray(pos, jnp.int32))
    tk, tv = t(ck), t(cv)
    got, gk, gv = tl.attention_decode(tparams, tcfg, t(x), tk, tv, pos)
    assert gk is tk and gv is tv  # the preallocated cache, written in place
    close(got, want)
    close(gk, wk)
    close(gv, wv)


def test_swiglu():
    tree = perturbed(jl.swiglu_init(jax.random.PRNGKey(5), 64, 96), 5)
    x = np.random.default_rng(6).normal(0, 1, (B, S, 64)).astype(np.float32)
    close(tl.swiglu(jax.tree.map(t, tree), t(x)), jl.swiglu(tree, jnp.asarray(x)))


def _rwkv(seed=7):
    jcfg = jl.RWKV6Config(d_model=64, head_size=16)
    tcfg = tl.RWKV6Config(d_model=64, head_size=16)
    tree = perturbed(jl.rwkv6_init(jax.random.PRNGKey(seed), jcfg), seed)
    return jcfg, tcfg, tree, jax.tree.map(t, tree)


@pytest.mark.parametrize("steps", [S, 1])
def test_rwkv6_time_mix_with_state(steps):
    """Prefill (S tokens) and decode (1 token), from a carried state and last
    token."""
    jcfg, tcfg, tree, tparams = _rwkv()
    rng = np.random.default_rng(8)
    x = rng.normal(0, 1, (B, steps, 64)).astype(np.float32)
    st = rng.normal(0, 0.1, (B, 4, 16, 16)).astype(np.float32)
    xl = rng.normal(0, 1, (B, 64)).astype(np.float32)
    want = jl.rwkv6_time_mix(tree, jcfg, jnp.asarray(x), jnp.asarray(st), jnp.asarray(xl))
    got = tl.rwkv6_time_mix(tparams, tcfg, t(x), t(st), t(xl))
    for g, w in zip(got, want):
        close(g, w)
    plain = tl.rwkv6_time_mix(tparams, tcfg, t(x), t(st), t(xl), plain=True)
    close(plain[0], want[0])


def test_rwkv6_channel_mix():
    _, _, tree, tparams = _rwkv(9)
    rng = np.random.default_rng(10)
    x = rng.normal(0, 1, (B, S, 64)).astype(np.float32)
    xl = rng.normal(0, 1, (B, 64)).astype(np.float32)
    want = jl.rwkv6_channel_mix(tree, jnp.asarray(x), jnp.asarray(xl))
    got = tl.rwkv6_channel_mix(tparams, t(x), t(xl))
    for g, w in zip(got, want):
        close(g, w)


# ------------------------------------------------------------------ models


@pytest.fixture(scope="module")
def models():
    """Per arch: (repro cfg, repro params, port cfg, port params, tokens)."""
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg = jlm.reduced(j_get_config(arch))
        tcfg = tlm.reduced(get_config(arch))
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        tree = perturbed(jax.jit(jlm.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(i)),
                         seed=100 + i, scale=0.02)
        jparams = jax.tree.map(jnp.asarray, tree)
        tparams = lm_params_from_jax(tree, tcfg, device="cpu")
        toks = np.random.default_rng(i).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
        out[arch] = (jcfg, jparams, tcfg, tparams, lm_batch(tcfg, toks, seed=i))
    return out


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward(models, arch):
    jcfg, jparams, tcfg, tparams, batch = models[arch]
    want, want_aux = jlm.forward(jparams, jcfg, jax_batch(batch))
    got, aux = tlm.forward(tparams, tcfg, batch)
    assert got.shape == (B, S, tcfg.vocab_size) and aux.dtype == torch.float32
    close(got, want)
    # the MoE layers' load-balance loss (1e-6, tests/test_perf_variants.py's); 0 otherwise
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-6, rtol=0)
    assert (float(aux) > 0) == (tcfg.arch_type == "moe")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_step(models, arch):
    jcfg, jparams, tcfg, tparams, batch = models[arch]
    C = S + 4
    jl_last, jcache = jlm.prefill(jparams, jcfg, jax_batch(batch), capacity=C)
    tl_last, tcache = tlm.prefill(tparams, tcfg, batch, capacity=C)
    close(tl_last, jl_last)
    assert sorted(tcache) == sorted(jcache)
    for name in jcache:
        assert tcache[name].dtype == torch.float32 and tcache[name].shape == jcache[name].shape
        close(tcache[name], jcache[name], cache_tol(name, jcache[name]))
    nxt = np.asarray(jnp.argmax(jl_last, -1)).astype(np.int32)
    jd, jcache = jlm.decode_step(jparams, jcfg, jcache, jnp.asarray(nxt), jnp.asarray(S, jnp.int32))
    td, tcache2 = tlm.decode_step(tparams, tcfg, tcache, torch.from_numpy(nxt), S)
    assert tcache2 is tcache
    close(td, jd)
    for name in jcache:
        close(tcache[name], jcache[name], cache_tol(name, jcache[name]))
    # decode at S against the port's own forward on S + 1 tokens (a VLM's
    # decode step takes 1-D RoPE at S: the forward's ids go on so)
    ext = dict(batch, tokens=np.concatenate([batch["tokens"], nxt[:, None]], 1))
    if "positions_3d" in batch:
        ext["positions_3d"] = np.concatenate(
            [batch["positions_3d"], np.full((3, B, 1), S, np.int32)], 2)
    full, _ = tlm.forward(tparams, tcfg, ext)
    close(td, full[:, -1].numpy(), atol=5e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_tokens_equal(models, arch):
    jcfg, jparams, tcfg, tparams, batch = models[arch]
    want = np.asarray(j_generate(jparams, jcfg, jax_batch(batch), steps=6))
    got = generate(tparams, tcfg, batch, steps=6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_generate_draws_from_the_distribution(models):
    jcfg, jparams, tcfg, tparams, batch = models["yi_6b"]
    toks = batch["tokens"]
    g = torch.Generator().manual_seed(0)
    a = generate(tparams, tcfg, {"tokens": toks}, steps=4, greedy=False, generator=g)
    assert a.shape == (B, 4) and int(a.min()) >= 0 and int(a.max()) < tcfg.vocab_size
    b = generate(tparams, tcfg, {"tokens": toks}, steps=4, greedy=False,
                 generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)  # the same generator state gives the same draws


def test_bfloat16_forward():
    """At bfloat16 the reference rounds attention probabilities to bf16
    before P.V (``layers.py:212``) while the port's attention keeps them in
    float32, and the two frameworks round matmuls differently; logits of
    magnitude ~1 then agree to a few bf16 ulps (2^-8 = 0.0039 each): the
    tolerance is 0.05, and greedy tokens must still agree on most rows."""
    arch = "qwen2_7b"
    jcfg = dataclasses.replace(jlm.reduced(j_get_config(arch)), dtype="bfloat16")
    tcfg = dataclasses.replace(tlm.reduced(get_config(arch)), dtype="bfloat16")
    tree = perturbed(jlm.init_params(jcfg, jax.random.PRNGKey(11)), seed=11, scale=0.02)
    tparams = lm_params_from_jax(tree, tcfg, device="cpu")
    assert tparams["embed"].dtype == torch.bfloat16
    toks = np.random.default_rng(11).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    want, _ = jlm.forward(jax.tree.map(jnp.asarray, tree), jcfg, {"tokens": jnp.asarray(toks)})
    got, _ = tlm.forward(tparams, tcfg, {"tokens": toks})
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=0.05)


def expert_sets(ids_by_layer, B, S):
    """Each MoE layer's expert ids (any grouping) as sorted sets: (L, B, S, K)."""
    return np.stack([np.sort(np.asarray(i).reshape(B, S, -1), -1) for i in ids_by_layer])


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "deepseek_v2_lite_16b"])
def test_bfloat16_forward_moe(arch, monkeypatch):
    """test_bfloat16_forward for the MoE family.  The router stays float32
    (carried across as float32; it routes the bf16 tokens in float32), the
    experts and MLA compute in bf16.  The two frameworks' bf16 roundings
    move a router logit by ~2^-8 of itself, which can flip a token's expert
    set (the reference's own semantics, not a fault): each layer's expert
    sets are read from both packages (repro's ``jax.lax.top_k``, the port's
    ``moe_routing``), and the logits are held at 0.05 on the positions whose
    own expert set agrees in every layer (at least 90% of them).  The aux
    loss at 1e-5 (a float32 mean over probabilities of bf16 tokens) plus
    what the flips move it by: a flipped token moves up to 2K entries of
    the load share f by 1/T each, so aux by up to aux_weight E 2K / T."""
    jcfg = dataclasses.replace(jlm.reduced(j_get_config(arch)), dtype="bfloat16")
    tcfg = dataclasses.replace(tlm.reduced(get_config(arch)), dtype="bfloat16")
    tree = perturbed(jlm.init_params(jcfg, jax.random.PRNGKey(12)), seed=12, scale=0.02)
    tparams = lm_params_from_jax(tree, tcfg, device="cpu")
    assert tparams["moe_layers"]["moe"]["router"].dtype == torch.float32
    assert tparams["moe_layers"]["moe"]["w_gate"].dtype == torch.bfloat16
    toks = np.random.default_rng(12).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    theirs, ours = [], []
    top_k, routing = jax.lax.top_k, tl.moe_routing

    def record_top_k(x, k):
        out = top_k(x, k)
        jax.debug.callback(lambda ids: theirs.append(np.asarray(ids)), out[1], ordered=True)
        return out

    def record_routing(*args):
        r = routing(*args)
        ours.append(r.expert_ids.numpy())
        assert bool(r.keep.all())  # capacity_factor 8: nothing drops
        return r

    monkeypatch.setattr(jax.lax, "top_k", record_top_k)
    monkeypatch.setattr(tl, "moe_routing", record_routing)
    want, want_aux = jlm.forward(jax.tree.map(jnp.asarray, tree), jcfg, {"tokens": jnp.asarray(toks)})
    got, aux = tlm.forward(tparams, tcfg, {"tokens": toks})
    assert got.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert len(theirs) == len(ours) == tcfg.num_layers - tcfg.first_k_dense
    same = (expert_sets(theirs, B, S) == expert_sets(ours, B, S)).all(axis=3)  # (L, B, S)
    agree = same.all(axis=0)
    assert agree.mean() >= 0.9, agree
    np.testing.assert_allclose(got.float().numpy()[agree], np.asarray(want, np.float32)[agree],
                               atol=0.05)
    mc = tcfg.moe()
    flips = int((~same).sum())
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=0,
                               atol=1e-5 + mc.aux_weight * mc.num_experts * 2 * mc.top_k * flips / (B * S))


def test_bonus_stays_float32_in_bfloat16():
    cfg = dataclasses.replace(tlm.reduced(get_config("rwkv6_1b6")), dtype="bfloat16")
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert params["layers"]["tm"]["bonus"].dtype == torch.float32
    assert params["layers"]["tm"]["wr"].dtype == torch.bfloat16
    assert params["layers"]["tm"]["wr"].shape == (2, 128, 128)


def test_init_params_shapes_match_repro():
    for arch in ARCHS:
        jcfg, tcfg = jlm.reduced(j_get_config(arch)), tlm.reduced(get_config(arch))
        shapes = jax.eval_shape(lambda k: jlm.init_params(jcfg, k), jax.random.PRNGKey(0))
        params = tlm.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
        want = jax.tree.map(lambda s: tuple(s.shape), shapes)
        got = jax.tree.map(lambda p: tuple(p.shape), params)
        assert got == want, arch


def test_truncate_params_shares_storage(models):
    _, _, tcfg, tparams, batch = models["qwen2_7b"]
    toks = batch["tokens"]
    weak = truncate_params(tparams, tcfg, 1)
    for name in ("embed", "unembed"):
        assert weak[name] is tparams[name]
    wq, full = weak["layers"]["attn"]["wq"], tparams["layers"]["attn"]["wq"]
    assert wq.shape[0] == 1 and wq.data_ptr() == full.data_ptr()
    assert wq.untyped_storage().data_ptr() == full.untyped_storage().data_ptr()
    wcfg = truncated_config(tcfg, 1)
    assert wcfg.num_layers == 1
    logits, _ = tlm.forward(weak, wcfg, {"tokens": toks})
    assert logits.shape == (B, S, tcfg.vocab_size)


@pytest.mark.parametrize("entry", ["init_params", "init_cache", "lm_params_from_jax"])
def test_unported_families_raise(entry):
    """Every family of the registry is ported; an arch_type that no config
    has raises ValueError at each entry point that reads it."""
    assert {c.arch_type for c in all_configs().values()} == set(tlm.PORTED_ARCHS)
    cfg = dataclasses.replace(tlm.reduced(get_config("yi_6b")), arch_type="retnet")
    call = {
        "init_params": lambda: tlm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"),
        "init_cache": lambda: tlm.init_cache(cfg, 1, 4, device="cpu"),
        "lm_params_from_jax": lambda: lm_params_from_jax({}, cfg, device="cpu"),
    }[entry]
    with pytest.raises(ValueError, match="unknown arch_type 'retnet'"):
        call()
