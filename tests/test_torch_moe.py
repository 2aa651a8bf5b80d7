"""The port's MoE and MLA layers against the JAX package's, on the CPU.

MoE: ``moe_apply_flat`` / ``moe_apply_grouped`` / ``moe_apply`` on the same
numpy weights and tokens, with and without dropped assignments, on both
sides of the dispatch rule (``groups`` divides B * S or not), and with tied
router rows.  The routing integers are held exactly: the expert ids against
the ids ``repro``'s own ``jax.lax.top_k`` returned in the same call, the
positions in expert and the keep mask against a numpy count over those ids.
Outputs at 1e-5, the aux loss at 1e-6 (``tests/test_perf_variants.py``'s),
gradients against ``jax.grad`` at 1e-5 of each leaf's largest |g|.

MLA: ``mla_apply`` (with ``return_kv``) and ``mla_decode`` (the absorbed
form, its slot clamped at C - 1) at 1e-5; the absorbed decode against the
expanded forward at 5e-4 (``tests/test_archs_smoke.py``'s decode tolerance);
the compressed cache as ``test_mla_cache_is_compressed`` checks it.  Then
the two-stack truncation of the cascade."""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_parity import perturbed  # first: it imports repro.detection before repro's kernels
import jax
import jax.numpy as jnp
from repro.configs import get_config as j_get_config
from repro.models import layers as jl
from repro.models import lm as jlm
from repro.serving.cascade_serving import truncate_params as j_truncate_params
from repro.serving.cascade_serving import truncated_config as j_truncated_config

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import layers as tl
from repro_torch.models import lm as tlm
from repro_torch.serving.cascade_serving import truncate_params, truncated_config

M, E, K, FF = 32, 8, 2, 16


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


def moe_case(seed, capacity_factor, groups=4, tied=False, skew=False, num_shared=1):
    """(repro cfg, port cfg, numpy params, port params).  ``tied`` gives
    experts 2 and 3 one router column; ``skew`` sends every token with a
    positive mean to expert 0 (so that, at capacity_factor 1.25, expert 0
    drops)."""
    jcfg = jl.MoEConfig(d_model=M, d_ff_expert=FF, num_experts=E, top_k=K,
                        num_shared=num_shared, capacity_factor=capacity_factor, groups=groups)
    tcfg = tl.MoEConfig(*jcfg)
    tree = perturbed(jl.moe_init(jax.random.PRNGKey(seed), jcfg), seed, scale=0.05)
    if tied:
        tree["router"][:, 3] = tree["router"][:, 2]
    if skew:
        tree["router"][:, 0] = 0.5
    return jcfg, tcfg, tree, jax.tree.map(t, tree)


def tokens(seed, B, S, skew=False, zero_rows=()):
    x = np.random.default_rng(seed).normal(0, 1, (B, S, M)).astype(np.float32)
    if skew:
        x += 1.0
    for b, s in zero_rows:
        x[b, s] = 0.0  # uniform router probabilities: every expert ties
    return x


def repro_routing(monkeypatch, fn, *args):
    """``fn(*args)`` of repro, and the (gate, ids) its ``jax.lax.top_k`` gave."""
    seen = []
    top_k = jax.lax.top_k

    def record(x, k):
        out = top_k(x, k)
        seen.append(tuple(np.asarray(a) for a in out))
        return out

    monkeypatch.setattr(jax.lax, "top_k", record)
    out = fn(*args)
    monkeypatch.setattr(jax.lax, "top_k", top_k)
    (gate, ids), = seen
    return out, gate, ids


def numpy_positions(ids, capacity):
    """Each assignment's slot in its expert, counted in token order within
    its group: ids (G, Tg, K) -> (pos, keep), each (G, Tg * K)."""
    flat = ids.reshape(ids.shape[0], -1)
    pos = np.zeros_like(flat)
    for g in range(flat.shape[0]):
        seen = {}
        for j, e in enumerate(flat[g]):
            pos[g, j] = seen.get(int(e), 0)
            seen[int(e)] = pos[g, j] + 1
    return pos, pos < capacity


def check_routing(tcfg, tparams, x, ids, G):
    """The port's routing of x in G groups against repro's ids (exactly)."""
    r = tl.moe_routing(tparams, tcfg, t(x).reshape(-1, M), G)
    want_ids = ids.reshape(G, -1, K)
    np.testing.assert_array_equal(r.expert_ids.numpy(), want_ids)
    pos, keep = numpy_positions(want_ids, r.capacity)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    return r


PATHS = {"flat": (jl.moe_apply_flat, tl.moe_apply_flat),
         "grouped": (jl.moe_apply_grouped, tl.moe_apply_grouped)}


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("capacity_factor", [8.0, 1.25])
def test_moe_paths_match_repro(monkeypatch, path, capacity_factor):
    """Output, aux and routing of each path; at 1.25 the skewed router makes
    expert 0 overflow, so assignments drop."""
    skew = capacity_factor < 2
    jcfg, tcfg, tree, tparams = moe_case(1, capacity_factor, skew=skew)
    x = tokens(2, 4, 16, skew=skew)
    jfn, tfn = PATHS[path]
    (want, want_aux), _, ids = repro_routing(monkeypatch, jfn, tree, jcfg, jnp.asarray(x))
    got, aux = tfn(tparams, tcfg, t(x))
    assert got.shape == x.shape and aux.dtype == torch.float32
    close(got, want)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-6, rtol=0)
    r = check_routing(tcfg, tparams, x, ids, jcfg.groups if path == "grouped" else 1)
    cap = int((r.expert_ids.shape[1] * K / E) * capacity_factor) + 1
    assert r.capacity == cap
    assert bool((~r.keep).any()) == skew  # drops exactly in the skewed case


@pytest.mark.parametrize("B,S,grouped", [(4, 16, True), (3, 5, False), (1, 4, True), (2, 3, False)])
def test_moe_apply_dispatch_rule_matches_repro(monkeypatch, B, S, grouped):
    """``moe_apply`` takes the grouped path exactly when groups divides B * S."""
    jcfg, tcfg, tree, tparams = moe_case(3, 1.25, groups=4)
    x = tokens(4, B, S)
    assert tl.moe_grouped(tcfg, B * S) == grouped
    (want, want_aux), _, ids = repro_routing(monkeypatch, jl.moe_apply, tree, jcfg, jnp.asarray(x))
    got, aux = tl.moe_apply(tparams, tcfg, t(x))
    close(got, want)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-6, rtol=0)
    check_routing(tcfg, tparams, x, ids, 4 if grouped else 1)
    if not grouped:
        assert torch.equal(got, tl.moe_apply_flat(tparams, tcfg, t(x))[0])


@pytest.mark.parametrize("path", list(PATHS))
def test_moe_tied_router_rows_go_to_the_lower_index(monkeypatch, path):
    """Two tied experts (one router column for experts 2 and 3) and all-zero
    tokens (every expert ties): the lower index wins, as in jax.lax.top_k."""
    jcfg, tcfg, tree, tparams = moe_case(5, 8.0, tied=True)
    x = tokens(6, 4, 16, zero_rows=((0, 0), (1, 3), (3, 15)))
    jfn, tfn = PATHS[path]
    (want, _), _, ids = repro_routing(monkeypatch, jfn, tree, jcfg, jnp.asarray(x))
    close(tfn(tparams, tcfg, t(x))[0], want)
    r = check_routing(tcfg, tparams, x, ids, jcfg.groups if path == "grouped" else 1)
    ids = r.expert_ids.reshape(4, 16, K)
    for b, s in ((0, 0), (1, 3), (3, 15)):
        assert ids[b, s].tolist() == [0, 1]
    has2, has3 = (ids == 2).any(-1), (ids == 3).any(-1)
    assert bool(has2.any()) and not bool((has3 & ~has2).any())  # 3 never wins over its tie 2


def test_moe_gate_is_normalised_and_cast(monkeypatch):
    """The gate is the top-K probabilities over max(their sum, 1e-9), in the
    activation type; the router stays float32 whatever that type is."""
    jcfg, tcfg, tree, tparams = moe_case(7, 8.0)
    x = tokens(8, 2, 8)
    _, gate, _ = repro_routing(monkeypatch, jl.moe_apply_flat, tree, jcfg, jnp.asarray(x))
    r = tl.moe_routing(tparams, tcfg, t(x).reshape(-1, M), 1)
    # the two packages' float32 softmax differ by an ulp (~1e-7)
    close(r.gate[0], gate / np.maximum(gate.sum(-1, keepdims=True), 1e-9), atol=1e-6)
    bf = tl.moe_routing(tparams, tcfg, t(x).reshape(-1, M).bfloat16(), 1)
    assert bf.gate.dtype == torch.bfloat16 and bf.probs.dtype == torch.float32
    p = tl.moe_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16, stack=3)
    assert p["router"].dtype == torch.float32 and p["w_gate"].dtype == torch.bfloat16
    assert p["router"].shape == (3, M, E) and p["w_down"].shape == (3, E, FF, M)


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("capacity_factor", [8.0, 1.25])
def test_moe_gradients_match_repro(path, capacity_factor):
    """jax.grad of (out . g) + aux against autograd: router, experts, shared
    and the tokens."""
    skew = capacity_factor < 2
    jcfg, tcfg, tree, tparams = moe_case(9, capacity_factor, skew=skew)
    x = tokens(10, 4, 16, skew=skew)
    up = np.random.default_rng(11).normal(0, 1, x.shape).astype(np.float32)
    jfn, tfn = PATHS[path]

    def jloss(p, xx):
        out, aux = jfn(p, jcfg, xx)
        return jnp.sum(out * up) + aux

    want_p, want_x = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    leaves = {k: v.requires_grad_() for k, v in tlm.tree_map(torch.clone, tparams).items()
              if not isinstance(v, dict)}
    shared = {k: v.requires_grad_() for k, v in tlm.tree_map(torch.clone, tparams["shared"]).items()}
    xt = t(x).requires_grad_()
    out, aux = tfn({**leaves, "shared": shared}, tcfg, xt)
    (out * t(up)).sum().add(aux).backward()
    for name, g in [*leaves.items(), *((f"shared/{k}", v) for k, v in shared.items())]:
        w = np.asarray(want_p["shared"][name[7:]] if name.startswith("shared/") else want_p[name])
        close(g.grad, w, atol=1e-5 * np.abs(w).max())
    close(xt.grad, want_x, atol=1e-5 * np.abs(np.asarray(want_x)).max())


@pytest.mark.parametrize("path", list(PATHS))
def test_moe_is_the_kept_experts_gated_plus_shared(path):
    """Token by token: the shared experts plus, over the token's kept
    assignments only, gate x its expert's SwiGLU (the skewed router drops
    most of expert 0's)."""
    _, tcfg, _, tparams = moe_case(12, 1.25, skew=True)
    x = t(tokens(13, 4, 16, skew=True)).reshape(-1, M)
    G = 4 if path == "grouped" else 1
    out, _ = PATHS[path][1](tparams, tcfg, x.reshape(4, 16, M))
    r = tl.moe_routing(tparams, tcfg, x, G)
    ids, gate, keep = r.expert_ids.reshape(-1, K), r.gate.reshape(-1, K), r.keep.reshape(-1, K)
    assert bool((~keep).any()) and bool(keep.any())
    want = tl.swiglu(tparams["shared"], x)
    for i in range(x.shape[0]):
        for k in range(K):
            if keep[i, k]:
                e = int(ids[i, k])
                h = F.silu(x[i] @ tparams["w_gate"][e]) * (x[i] @ tparams["w_up"][e])
                want[i] += gate[i, k] * (h @ tparams["w_down"][e])
    # float32 in another summation order, outputs up to ~20: 1e-6 of the largest
    close(out.reshape(-1, M), want.numpy(), atol=1e-6 * float(want.abs().max()))


# ------------------------------------------------------------------ MLA

R, NOPE, ROPE, V, H = 32, 16, 8, 16, 4


def mla_case(seed):
    jcfg = jl.MLAConfig(d_model=M, num_heads=H, kv_lora_rank=R, qk_nope_dim=NOPE,
                        qk_rope_dim=ROPE, v_dim=V, rope_theta=1e4)
    tcfg = tl.MLAConfig(*jcfg)
    tree = perturbed(jl.mla_init(jax.random.PRNGKey(seed), jcfg), seed, scale=0.05)
    return jcfg, tcfg, tree, jax.tree.map(t, tree)


def test_mla_init_shapes_match_repro():
    jcfg, tcfg, tree, _ = mla_case(0)
    got = tl.mla_init(torch.Generator().manual_seed(0), tcfg, stack=2)
    want = jax.tree.map(lambda a: (2, *a.shape), tree)
    assert jax.tree.map(lambda a: tuple(a.shape), got) == want


@pytest.mark.parametrize("S", [1, 12])
def test_mla_apply_matches_repro(S):
    jcfg, tcfg, tree, tparams = mla_case(1)
    x = np.random.default_rng(S).normal(0, 1, (2, S, M)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (2, S)).copy()
    want, (wc, wkr) = jl.mla_apply(tree, jcfg, jnp.asarray(x), jnp.asarray(pos), return_kv=True)
    got, (gc, gkr) = tl.mla_apply(tparams, tcfg, t(x), torch.from_numpy(pos), return_kv=True)
    assert gc.shape == (2, S, R) and gkr.shape == (2, S, ROPE)
    close(got, want)
    close(gc, wc)
    close(gkr, wkr)
    close(tl.mla_apply(tparams, tcfg, t(x), torch.from_numpy(pos)), want)


@pytest.mark.parametrize("pos", [0, 9, 13, 20])
def test_mla_decode_matches_repro(pos):
    """Against repro's absorbed decode; pos 13 and 20 lie past the 12 slots,
    where the write clamps to the last slot and every slot is valid."""
    jcfg, tcfg, tree, tparams = mla_case(2)
    rng = np.random.default_rng(3 + pos)
    C = 12
    x = rng.normal(0, 1, (2, 1, M)).astype(np.float32)
    cc = rng.normal(0, 1, (2, C, R)).astype(np.float32)
    ckr = rng.normal(0, 1, (2, C, ROPE)).astype(np.float32)
    want, wc, wkr = jl.mla_decode(tree, jcfg, jnp.asarray(x), jnp.asarray(cc), jnp.asarray(ckr),
                                  jnp.asarray(pos, jnp.int32))
    tc, tkr = t(cc), t(ckr)
    got, gc, gkr = tl.mla_decode(tparams, tcfg, t(x), tc, tkr, pos)
    assert gc is tc and gkr is tkr  # the preallocated cache, written in place
    close(got, want)
    close(gc, wc)
    close(gkr, wkr)


def test_mla_absorbed_decode_matches_expanded_forward():
    """Prefill's latents, then the absorbed decode at position S, against
    the expanded form over S + 1 tokens (5e-4)."""
    _, tcfg, _, tparams = mla_case(4)
    S, C = 10, 14
    x = t(np.random.default_rng(5).normal(0, 1, (2, S + 1, M)))
    pos = torch.arange(S + 1)[None].expand(2, S + 1)
    full = tl.mla_apply(tparams, tcfg, x, pos)
    _, (c, kr) = tl.mla_apply(tparams, tcfg, x[:, :S], pos[:, :S], return_kv=True)
    cache_c, cache_kr = torch.zeros(2, C, R), torch.zeros(2, C, ROPE)
    cache_c[:, :S], cache_kr[:, :S] = c, kr
    got, _, _ = tl.mla_decode(tparams, tcfg, x[:, S:], cache_c, cache_kr, S)
    close(got, full[:, S:].numpy(), atol=5e-4)


def test_mla_cache_is_compressed():
    """tests/test_archs_smoke.py::test_mla_cache_is_compressed on the port,
    and the cache's shapes against repro's."""
    cfg = tlm.reduced(get_config("deepseek_v2_lite_16b"))
    cache = tlm.init_cache(cfg, batch=1, capacity=64, device="cpu")
    per_tok = sum(v.numel() for v in cache.values()) / (cfg.num_layers * 64)
    assert per_tok < 2 * cfg.num_heads * cfg.head_dim
    want = jlm.init_cache(jlm.reduced(j_get_config("deepseek_v2_lite_16b")), 1, 64, abstract=True)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {k: v.shape for k, v in want.items()}
    mla = tlm.init_cache(tlm.reduced(get_config("deepseek_v2_lite_16b")), 8, 24, device="cpu")
    expanded = tlm.init_cache(tlm.reduced(get_config("deepseek_moe_16b")), 8, 24, device="cpu")
    assert sorted(mla) == ["c", "kr"] and sorted(expanded) == ["k", "v"]
    assert mla["c"].shape == (2, 8, 24, 32) and expanded["k"].shape == (2, 8, 24, 2, 32)


# ------------------------------------------------------------------ two stacks


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "deepseek_v2_lite_16b"])
@pytest.mark.parametrize("exit_layer", [1, 2, 3])
def test_truncate_params_cuts_both_stacks_as_repro(arch, exit_layer):
    """Three layers, one dense: exit 1 keeps the dense layer and a MoE stack
    of length 0, exit 2 and 3 one and two MoE layers.  Every tensor is a
    view; the weak forward equals repro's."""
    jcfg = jlm.reduced(j_get_config(arch), num_layers=3)
    tcfg = tlm.reduced(get_config(arch), num_layers=3)
    tree = perturbed(jlm.init_params(jcfg, jax.random.PRNGKey(exit_layer)), 40 + exit_layer)
    tparams = lm_params_from_jax(tree, tcfg, device="cpu")
    weak = truncate_params(tparams, tcfg, exit_layer)
    want = j_truncate_params(tree, jcfg, exit_layer)
    assert sorted(weak) == sorted(want)
    assert jax.tree.map(lambda a: tuple(a.shape), weak) == jax.tree.map(lambda a: a.shape, want)
    for name in ("dense_layers", "moe_layers"):
        got, full = weak[name]["norm1"]["scale"], tparams[name]["norm1"]["scale"]
        assert got.untyped_storage().data_ptr() == full.untyped_storage().data_ptr()
    wcfg = truncated_config(tcfg, exit_layer)
    assert (wcfg.num_layers, wcfg.first_k_dense) == (exit_layer, 1)
    toks = np.random.default_rng(exit_layer).integers(0, tcfg.vocab_size, (2, 8)).astype(np.int32)
    jwant, jaux = jlm.forward(jax.tree.map(jnp.asarray, want), j_truncated_config(jcfg, exit_layer),
                              {"tokens": jnp.asarray(toks)})
    got, aux = tlm.forward(weak, wcfg, {"tokens": toks})
    close(got, jwant)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=0)
    assert (float(aux) == 0.0) == (exit_layer == 1)


def test_layer_count_is_checked_over_both_stacks():
    cfg = tlm.reduced(get_config("deepseek_moe_16b"), num_layers=3)
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert params["dense_layers"]["mlp"]["gate"].shape[0] == 1
    assert params["moe_layers"]["moe"]["router"].shape[0] == 2
    with pytest.raises(ValueError, match="layers"):
        tlm.forward(params, dataclasses.replace(cfg, num_layers=4), {"tokens": np.zeros((1, 4), np.int32)})
    with pytest.raises(ValueError, match="layers"):
        tlm.forward(params, dataclasses.replace(cfg, first_k_dense=2), {"tokens": np.zeros((1, 4), np.int32)})
    # a config of only dense layers leaves the MoE stack out, as repro's does
    only = tlm.init_params(dataclasses.replace(cfg, num_layers=1), torch.Generator().manual_seed(0),
                           device="cpu")
    assert "moe_layers" not in only
