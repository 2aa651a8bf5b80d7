"""The two dense-attention decode caches in the port against the JAX
package's, on the CPU: the sliding-window ring cache (``window > 0``,
capacity below the prompt) and the int8 KV cache (``kv_quant``), with the
registry's ``long_context_variant`` / ``all_configs``, the hybrid
family's ring (its shared attention windowed, its SSM and conv states
carried as they are) and the encoder-decoder's (its decoder self-attention
windowed; its cross-attention cache holds every frame and ignores
``kv_quant``, as the JAX package's does).

Tolerances: ``kv_quantize`` bit for bit (int8 values and scales); prefill
and decode logits at 2e-4 / 5e-4, those of
``tests/test_archs_smoke.py::test_sliding_window_decode_ring_buffer``; the
int8 cache against the bf16 cache at 5% of the largest logit
(``tests/test_perf_variants.py::test_int8_cache_decode_close``)."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import modality_fields, perturbed  # first: it imports repro.detection before repro's kernels
import jax
import jax.numpy as jnp
from repro import configs as jconfigs
from repro.models import layers as jl
from repro.models import lm as jlm

from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels.flash_sdpa.ops import decode_plan
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import layers as tl
from repro_torch.models import lm as tlm

ARCHS = ["yi_6b", "qwen2_7b", "deepseek_moe_16b"]  # the MoE family attends as the dense one
RING_ARCHS = ARCHS + ["whisper_base"]
WINDOW, S = 8, 12
DECODE_STEPS = 3  # decode steps past the ring's boundary (positions S, S + 1, ...)


def close(got, want, atol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


def pair(arch, seed, **overrides):
    """(repro cfg, repro params, port cfg, port params) of the reduced arch."""
    jcfg = dataclasses.replace(jlm.reduced(jconfigs.get_config(arch)), **overrides)
    tcfg = dataclasses.replace(tlm.reduced(tconfigs.get_config(arch)), **overrides)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    tree = perturbed(jax.jit(jlm.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(seed)),
                     seed=300 + seed)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, lm_params_from_jax(tree, tcfg, device="cpu")


def tokens(cfg, B, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n)).astype(np.int32)


def inputs(cfg, toks, seed):
    """The port's batch of ``toks`` and repro's: an encoder-decoder's carries
    seeded audio frames (the same for any length of ``toks``)."""
    batch = {"tokens": toks, **modality_fields(cfg, toks.shape[0], toks.shape[1], seed)}
    return batch, {k: jnp.asarray(v) for k, v in batch.items()}


# ------------------------------------------------------------------ int8


def test_kv_quantize_bit_equal_to_repro():
    """Random keys, rows whose values fall on .5 after scaling (round half
    to even), and all-zero rows (the 1e-8 floor of the scale)."""
    rng = np.random.default_rng(0)
    k = rng.normal(0, 2, (3, 17, 4, 32)).astype(np.float32)
    k[0, 0, 0] = 0.0
    k[0, 1, :] = 0.0
    ties = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5], np.float32)
    k[1, 2, 0] = np.tile(ties, 4)  # amax 127: the scale is exactly 1
    k[1, 2, 1] = np.tile(ties, 4) / 8  # a power-of-two scale keeps the ties exact
    want_q, want_s = jl.kv_quantize(jnp.asarray(k))
    got_q, got_s = tl.kv_quantize(torch.from_numpy(k))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_q[1, 2, 0, :8].tolist() == [127, 2, -4, 0, 0, 2, 126, -126]  # half to even
    assert float(got_s[0, 1, 0]) == np.float32(1e-8) / np.float32(127.0)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = tl.kv_dequantize(got_q, got_s, dt).float().numpy()
        np.testing.assert_array_equal(got, np.asarray(jl.kv_dequantize(want_q, want_s, jdt), np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_prefill_and_decode_match_repro(arch):
    """Int8 prefill and decode against repro's at the ring tolerances; the
    cache's int8 values equal repro's except where a float32 rounding apart
    puts a value on the other side of .5 (one unit, rarely)."""
    jcfg, jparams, tcfg, tparams = pair(arch, 1, kv_quant=True)
    B, C = 2, S + 4
    toks = tokens(tcfg, B, S, 1)
    jlast, jcache = jlm.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, capacity=C)
    tlast, tcache = tlm.prefill(tparams, tcfg, {"tokens": toks}, capacity=C)
    close(tlast, jlast, 2e-4)
    assert sorted(tcache) == sorted(jcache) == ["k", "k_s", "v", "v_s"]
    assert tcache["k"].dtype == torch.int8 and tcache["k_s"].shape == (tcfg.num_layers, B, C, 2)
    for name in ("k", "v"):
        diff = np.abs(tcache[name].numpy().astype(int) - np.asarray(jcache[name]).astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, name
        np.testing.assert_allclose(tcache[f"{name}_s"].numpy(), np.asarray(jcache[f"{name}_s"]),
                                   rtol=1e-5, atol=0)
    nxt = np.asarray(jnp.argmax(jlast, -1)).astype(np.int32)
    for pos in range(S, S + DECODE_STEPS):
        jd, jcache = jlm.decode_step(jparams, jcfg, jcache, jnp.asarray(nxt), jnp.asarray(pos, jnp.int32))
        td, tcache = tlm.decode_step(tparams, tcfg, tcache, torch.from_numpy(nxt), pos)
        close(td, jd, 5e-4)
        nxt = np.asarray(jnp.argmax(jd, -1)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_cache_against_the_plain_cache(arch):
    """repro's own int8 test on the port: prefill logits bit-equal to the
    plain cache's, a smaller cache, decode within 5% of the largest logit."""
    _, _, tcfg, tparams = pair(arch, 2)
    qcfg = dataclasses.replace(tcfg, kv_quant=True)
    B, C = 2, S + 4
    toks = tokens(tcfg, B, S, 2)
    ll, cache = tlm.prefill(tparams, tcfg, {"tokens": toks}, capacity=C)
    llq, cacheq = tlm.prefill(tparams, qcfg, {"tokens": toks}, capacity=C)
    assert torch.equal(ll, llq)
    nbytes = lambda c: sum(t.numel() * t.element_size() for t in c.values())  # noqa: E731
    assert nbytes(cacheq) < nbytes(cache)
    nxt = ll.argmax(-1)
    d1, _ = tlm.decode_step(tparams, tcfg, cache, nxt, S)
    d2, _ = tlm.decode_step(tparams, qcfg, cacheq, nxt, S)
    assert float((d1 - d2).abs().max() / (d1.abs().max() + 1e-9)) < 0.05


# ------------------------------------------------------------------ ring


@pytest.mark.parametrize("S_,C", [(5, 8), (8, 8), (12, 8), (17, 8), (16, 8)])
def test_fill_slots_layout_equals_repro(S_, C):
    rng = np.random.default_rng(S_)
    arr = rng.normal(0, 1, (2, S_, 3, 4)).astype(np.float32)
    want = np.asarray(jlm._fill_slots(jnp.asarray(arr), C))
    out = torch.zeros((2, C, 3, 4))
    assert tlm._fill_slots(torch.from_numpy(arr), out) is out
    np.testing.assert_array_equal(out.numpy(), want)
    if S_ >= C:  # every slot written
        full = torch.full((2, C, 3, 4), 7.0)
        np.testing.assert_array_equal(tlm._fill_slots(torch.from_numpy(arr), full).numpy(), want)


@pytest.mark.parametrize("arch", RING_ARCHS)
@pytest.mark.parametrize("kv_quant", [False, True])
def test_ring_prefill_and_decode_match_repro(arch, kv_quant):
    """Prefill of S 12 into a ring of window 8, then decode steps past the
    boundary, against repro's prefill / decode_step (2e-4 / 5e-4); the ring
    cache's slots against repro's; and, as repro's own test does, against
    a forward under the same window."""
    jcfg, jparams, tcfg, tparams = pair(arch, 3, window=WINDOW, kv_quant=kv_quant)
    B = 1
    toks = tokens(tcfg, B, S, 3)
    tb, jb = inputs(tcfg, toks, 3)
    jlast, jcache = jlm.prefill(jparams, jcfg, jb, capacity=WINDOW)
    tlast, tcache = tlm.prefill(tparams, tcfg, tb, capacity=WINDOW)
    close(tlast, jlast, 2e-4)
    if not kv_quant or tcfg.arch_type == "encdec":  # the encoder-decoder's cache is never int8
        assert sorted(tcache) == sorted(jcache)
        for name in jcache:
            close(tcache[name], jcache[name], 1e-5)
    full, _ = tlm.forward(tparams, tcfg, tb)
    close(tlast, full[:, -1].numpy(), 2e-4)
    seq = toks
    nxt = np.asarray(jnp.argmax(jlast, -1)).astype(np.int32)
    for pos in range(S, S + DECODE_STEPS):
        jd, jcache = jlm.decode_step(jparams, jcfg, jcache, jnp.asarray(nxt), jnp.asarray(pos, jnp.int32))
        td, tcache = tlm.decode_step(tparams, tcfg, tcache, torch.from_numpy(nxt), pos)
        close(td, jd, 5e-4)
        seq = np.concatenate([seq, nxt[:, None]], 1)
        if not kv_quant:
            ref, _ = tlm.forward(tparams, tcfg, inputs(tcfg, seq, 3)[0])
            close(td, ref[:, -1].numpy(), 5e-4)
        nxt = np.asarray(jnp.argmax(jd, -1)).astype(np.int32)


@pytest.mark.parametrize("arch", RING_ARCHS)
def test_ring_decode_from_an_empty_ring_matches_repro(arch):
    """Prefill shorter than the ring, then decode across the boundary: slots
    fill in order (pos < C), then wrap (pos % C)."""
    jcfg, jparams, tcfg, tparams = pair(arch, 4, window=WINDOW)
    tb, jb = inputs(tcfg, tokens(tcfg, 1, 5, 4), 4)
    jlast, jcache = jlm.prefill(jparams, jcfg, jb, capacity=WINDOW)
    tlast, tcache = tlm.prefill(tparams, tcfg, tb, capacity=WINDOW)
    nxt = np.asarray(jnp.argmax(jlast, -1)).astype(np.int32)
    for pos in range(5, 5 + WINDOW + 2):  # through pos C - 1, C and C + 1
        jd, jcache = jlm.decode_step(jparams, jcfg, jcache, jnp.asarray(nxt), jnp.asarray(pos, jnp.int32))
        td, tcache = tlm.decode_step(tparams, tcfg, tcache, torch.from_numpy(nxt), pos)
        close(td, jd, 5e-4)
        nxt = np.asarray(jnp.argmax(jd, -1)).astype(np.int32)
    for name in jcache:
        close(tcache[name], jcache[name], 1e-5)


@pytest.mark.parametrize("C", [8, 256])
def test_decode_plan_covers_the_ring_at_its_boundary(C):
    """The decode route at q_offset = min(pos, C - 1), no window: up to the
    boundary it reads slots 0..pos, from pos = C - 1 on every slot."""
    for pos in (C - 2, C - 1, C, C + 1, 3 * C + 5):
        plan = decode_plan(8, 1, C, 28, 4, 128, True, 0, min(pos, C - 1))
        assert (plan.kbeg, plan.kend) == (0, min(pos, C - 1) + 1)
        assert plan.splits * plan.tiles_per_split * 32 >= plan.kend > (plan.splits - 1) * plan.tiles_per_split * 32


@pytest.mark.parametrize("window", [0, WINDOW])
def test_mla_decode_past_its_cache_clamps_as_repro(window):
    """MLA ignores the window (no ring) and writes slot min(pos, C - 1), as
    repro's dynamic_update_slice clamps: prefill of S into S slots (and of
    S into a window of 8, the last 8 at their ring slots, as repro lays
    them), then three decode steps past the end, against repro."""
    jcfg, jparams, tcfg, tparams = pair("deepseek_v2_lite_16b", 7, window=window)
    C = window or S
    toks = tokens(tcfg, 2, S, 7)
    jlast, jcache = jlm.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, capacity=C)
    tlast, tcache = tlm.prefill(tparams, tcfg, {"tokens": toks}, capacity=C)
    close(tlast, jlast, 2e-4)
    assert sorted(tcache) == ["c", "kr"] and tcache["c"].shape[2] == C
    nxt = np.asarray(jnp.argmax(jlast, -1)).astype(np.int32)
    for pos in range(S, S + DECODE_STEPS):
        jd, jcache = jlm.decode_step(jparams, jcfg, jcache, jnp.asarray(nxt), jnp.asarray(pos, jnp.int32))
        td, tcache = tlm.decode_step(tparams, tcfg, tcache, torch.from_numpy(nxt), pos)
        close(td, jd, 5e-4)
        nxt = np.asarray(jnp.argmax(jd, -1)).astype(np.int32)
    for name in jcache:
        close(tcache[name], jcache[name], 1e-5)


def test_decode_past_a_plain_cache_raises():
    _, _, tcfg, tparams = pair("yi_6b", 5)
    toks = tokens(tcfg, 1, 4, 5)
    _, cache = tlm.prefill(tparams, tcfg, {"tokens": toks}, capacity=4)
    with pytest.raises(ValueError, match="outside the cache"):
        tlm.decode_step(tparams, tcfg, cache, torch.zeros(1, dtype=torch.int32), 4)


@pytest.mark.parametrize("S_", [5, S])
def test_hybrid_ring_cache_matches_repro(S_):
    """zamba2-2.7b reduced under ``long_context_variant`` (window 8): prefill
    of S_ into the shared attention's ring of 8 (S_ = 12: the last 8 at their
    ring slots; S_ = 5: slots fill in order), then decode steps past the
    boundary, against repro (logits 2e-4 / 5e-4 as above; cache fields at
    1e-5, the SSM state at 1e-5 of its largest entry, tests/test_torch_lm.py)
    and against a forward under the same window."""
    jcfg = jconfigs.long_context_variant(jlm.reduced(jconfigs.get_config("zamba2_2b7")), WINDOW)
    tcfg = tconfigs.long_context_variant(tlm.reduced(tconfigs.get_config("zamba2_2b7")), WINDOW)
    tree = perturbed(jax.jit(jlm.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(8)), seed=308)
    jparams, tparams = jax.tree.map(jnp.asarray, tree), lm_params_from_jax(tree, tcfg, device="cpu")
    toks = tokens(tcfg, 2, S_, 8)
    jlast, jcache = jlm.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, capacity=WINDOW)
    tlast, tcache = tlm.prefill(tparams, tcfg, {"tokens": toks}, capacity=WINDOW)
    close(tlast, jlast, 2e-4)
    assert sorted(tcache) == sorted(jcache) == ["conv", "shared_k", "shared_v", "ssm"]
    assert tcache["shared_k"].shape[2] == WINDOW
    full, _ = tlm.forward(tparams, tcfg, {"tokens": toks})
    close(tlast, full[:, -1].numpy(), 2e-4)
    seq = toks
    nxt = np.asarray(jnp.argmax(jlast, -1)).astype(np.int32)
    end = WINDOW + 2 if S_ < WINDOW else S_ + DECODE_STEPS  # through pos C - 1, C and C + 1
    for pos in range(S_, end):
        jd, jcache = jlm.decode_step(jparams, jcfg, jcache, jnp.asarray(nxt), jnp.asarray(pos, jnp.int32))
        td, tcache = tlm.decode_step(tparams, tcfg, tcache, torch.from_numpy(nxt), pos)
        close(td, jd, 5e-4)
        seq = np.concatenate([seq, nxt[:, None]], 1)
        ref, _ = tlm.forward(tparams, tcfg, {"tokens": seq})
        close(td, ref[:, -1].numpy(), 5e-4)
        nxt = np.asarray(jnp.argmax(jd, -1)).astype(np.int32)
    for name in jcache:
        want = np.asarray(jcache[name])
        close(tcache[name], want, 1e-5 * max(1.0, float(np.abs(want).max())) if name == "ssm" else 1e-5)


def test_vlm_serve_step_broadcasts_the_position():
    """make_serve_step gives a VLM's decode step M-RoPE ids (3, B, 1) all
    equal to pos, as repro's serve_step does: the same logits as 1-D RoPE at
    pos (decode_step without ids, as generate calls it), bit for bit."""
    _, _, tcfg, tparams = pair("qwen2_vl_2b", 9)
    rng = np.random.default_rng(9)
    batch = {"tokens": tokens(tcfg, 2, S, 9),
             "vision_embeds": rng.normal(0, 1, (2, tcfg.vision_tokens, tcfg.d_model)).astype(np.float32),
             "positions_3d": rng.integers(0, S, (3, 2, S)).astype(np.int32)}
    last, cache = make_prefill_step(tcfg, S + 1)(tparams, batch)
    _, plain_cache = tlm.prefill(tparams, tcfg, batch, capacity=S + 1)
    logits, _ = make_serve_step(tcfg)(tparams, cache, last.argmax(-1), S)
    want, _ = tlm.decode_step(tparams, tcfg, plain_cache, last.argmax(-1), S)
    assert torch.equal(logits, want)


def test_prefill_and_serve_steps_are_prefill_and_decode_step():
    _, _, tcfg, tparams = pair("qwen2_7b", 6, window=WINDOW, kv_quant=True)
    toks = tokens(tcfg, 2, S, 6)
    last, cache = make_prefill_step(tcfg, WINDOW)(tparams, {"tokens": toks})
    want_last, want_cache = tlm.prefill(tparams, tcfg, {"tokens": toks}, capacity=WINDOW)
    assert torch.equal(last, want_last)
    logits, cache = make_serve_step(tcfg)(tparams, cache, last.argmax(-1), S)
    want, _ = tlm.decode_step(tparams, tcfg, want_cache, last.argmax(-1), S)
    assert torch.equal(logits, want)


# ------------------------------------------------------------------ registry


def test_long_context_variant_and_all_configs_equal_repro():
    jall, tall = jconfigs.all_configs(), tconfigs.all_configs()
    assert list(tall) == list(jall) == tconfigs.ARCH_IDS
    for arch in tconfigs.ARCH_IDS:
        assert dataclasses.asdict(tall[arch]) == dataclasses.asdict(jall[arch]), arch
        for window in (8192, 256):
            got = tconfigs.long_context_variant(tall[arch], window=window)
            want = jconfigs.long_context_variant(jall[arch], window=window)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), (arch, window)
    assert tconfigs.long_context_variant(tall["rwkv6_1b6"]) is tall["rwkv6_1b6"]
    assert tconfigs.long_context_variant(tall["qwen2_7b"]).window == 8192
