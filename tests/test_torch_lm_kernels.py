"""The port's LM kernels (their plain versions on the CPU) against the JAX
package's: ``flash_sdpa`` and ``wkv6`` in Pallas interpret mode, as
``tests/test_kernels.py`` runs them, and against the model code each kernel
replaces (``layers._sdpa``, the ``rwkv6_time_mix`` scan).  Same numpy inputs
for both packages, the reference's tolerances."""
import numpy as np
import pytest
import torch

import repro.detection.batch  # noqa: F401  (first: repro's kernels import it back)
import jax
import jax.numpy as jnp
from repro.kernels.flash_sdpa import flash_sdpa as j_flash_sdpa
from repro.kernels.wkv6 import wkv6 as j_wkv6
from repro.models import layers as jl

from repro_torch.kernels.flash_sdpa import flash_sdpa, flash_sdpa_ref
from repro_torch.kernels.wkv6 import wkv6, wkv6_ref


FLASH_CASES = [
    (1, 128, 128, 2, 1, 32, 0, 0),
    (2, 256, 256, 4, 2, 64, 0, 0),
    (1, 100, 300, 4, 4, 32, 0, 200),  # unpadded sizes + query offset
    (2, 256, 256, 4, 2, 64, 64, 0),  # sliding window
    (1, 64, 512, 8, 2, 128, 128, 448),  # windowed decode-tail
]


@pytest.mark.parametrize("B,S,T,H,K,D,window,off", FLASH_CASES)
def test_flash_sdpa_matches_repro(B, S, T, H, K, D, window, off):
    rng = np.random.default_rng(B * S + T + window)
    q = rng.normal(0, 1, (B, S, H, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, T, K, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, T, K, D)).astype(np.float32)
    want = j_flash_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), tq=64, tk=64,
                        window=window, q_offset=off)
    got = flash_sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                     window=window, q_offset=off)
    assert got.shape == (B, S, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


def test_flash_sdpa_matches_model_sdpa():
    """The kernel's function == repro's ``_sdpa`` under a causal mask, and ==
    its decode use (one query at ``q_offset = pos`` over a cache whose slots
    after ``pos`` hold garbage)."""
    rng = np.random.default_rng(1)
    q = rng.normal(0, 1, (2, 128, 4, 64)).astype(np.float32)
    k = rng.normal(0, 1, (2, 128, 2, 64)).astype(np.float32)
    v = rng.normal(0, 1, (2, 128, 2, 64)).astype(np.float32)
    want = jl._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jl.causal_mask(128, 128, 0), 2, 4).reshape(2, 128, 4, 64)
    got = flash_sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
    for pos in (0, 57):
        mask = (jnp.arange(128) <= pos)[None, None, :]
        want = jl._sdpa(jnp.asarray(q[:, :1]), jnp.asarray(k), jnp.asarray(v), mask, 2, 4)
        got = flash_sdpa(torch.from_numpy(q[:, :1].copy()), torch.from_numpy(k),
                         torch.from_numpy(v), q_offset=pos)
        np.testing.assert_allclose(got.numpy().reshape(2, 1, -1), np.asarray(want), atol=2e-6)


def test_flash_sdpa_fully_masked_rows_are_zero():
    # queries at positions 10..12 with a window of 2 see keys 9..12 at most;
    # the 4 keys sit at 0..3, so every row is fully masked
    q = torch.randn(1, 3, 2, 32)
    k = torch.randn(1, 4, 1, 32)
    out = flash_sdpa(q, k, k.clone(), window=2, q_offset=10)
    assert torch.equal(out, torch.zeros_like(out))


WKV_CASES = [(1, 8, 1, 8, 8), (2, 64, 3, 16, 16), (2, 33, 2, 64, 64)]


@pytest.mark.parametrize("B,T,H,K,V", WKV_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_matches_repro(B, T, H, K, V, dtype):
    rng = np.random.default_rng(B * T + K)
    arrays = dict(
        r=rng.normal(0, 1, (B, T, H, K)), k=rng.normal(0, 1, (B, T, H, K)),
        v=rng.normal(0, 1, (B, T, H, V)), w=rng.uniform(0.5, 0.99, (B, T, H, K)),
        u=rng.normal(0, 0.2, (H, K)), s0=rng.normal(0, 0.1, (B, H, K, V)),
    )
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jin = {n: jnp.asarray(a, jdt) for n, a in arrays.items()}
    # the same rounded values for the port: bf16 -> float32 is exact
    tin = {n: torch.from_numpy(np.array(x.astype(jnp.float32))).to(getattr(torch, dtype))
           for n, x in jin.items()}
    want_out, want_s = j_wkv6(*(jin[n] for n in ("r", "k", "v", "w", "u", "s0")))
    got_out, got_s = wkv6(*(tin[n] for n in ("r", "k", "v", "w", "u", "s0")))
    assert got_out.dtype == torch.float32 and got_s.shape == (B, H, K, V)
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), atol=tol, rtol=tol)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=tol, rtol=tol)


def test_wkv6_matches_model_time_mix_scan():
    """The port's kernel on the r/k/v/w/u the JAX layer computes gives the
    layer's output and state (the inner scan of ``rwkv6_time_mix``)."""
    cfg = jl.RWKV6Config(d_model=64, head_size=16)
    params = jl.rwkv6_init(jax.random.PRNGKey(0), cfg)
    params = {k: v.at[...].set(jax.random.normal(jax.random.PRNGKey(3), v.shape) * 0.3)
              if k == "bonus" else v for k, v in params.items()}
    rng = np.random.default_rng(2)
    B, S, M, H, Hd = 2, 12, 64, 4, 16
    x = jnp.asarray(rng.normal(0, 1, (B, S, M)), jnp.float32)
    s0 = jnp.asarray(rng.normal(0, 0.1, (B, H, Hd, Hd)), jnp.float32)
    out_model, state_model, _ = jl.rwkv6_time_mix(params, cfg, x, s0)
    x_prev = jnp.concatenate([jnp.zeros((B, 1, M)), x[:, :-1]], axis=1)
    xr, xk, xv, xg, xw = [jl._rwkv6_mix(params, x, x_prev)[:, :, i] for i in range(5)]
    r = (xr @ params["wr"]).reshape(B, S, H, Hd)
    k = (xk @ params["wk"]).reshape(B, S, H, Hd)
    v = (xv @ params["wv"]).reshape(B, S, H, Hd)
    dl = jnp.tanh(xw @ params["decay_lora_a"]) @ params["decay_lora_b"]
    w = jnp.exp(-jnp.exp(params["decay_base"] + dl)).reshape(B, S, H, Hd)
    t = [torch.from_numpy(np.array(a, np.float32)) for a in (r, k, v, w, params["bonus"], s0)]
    out_k, state_k = wkv6(*t)
    np.testing.assert_allclose(state_k.numpy(), np.asarray(state_model), atol=1e-5)
    g = jax.nn.silu(xg @ params["wg"])
    out = jl.layernorm(params["ln_x"], jnp.asarray(out_k.numpy()).reshape(B, S, M)) * g
    np.testing.assert_allclose(np.asarray(out @ params["wo"]), np.asarray(out_model), atol=1e-5)


def test_wrappers_take_the_plain_version_on_cpu():
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.normal(0, 1, (1, 5, 2, 32)).astype(np.float32))
    k = torch.from_numpy(rng.normal(0, 1, (1, 7, 1, 32)).astype(np.float32))
    before = flash_sdpa.launches
    assert torch.equal(flash_sdpa(q, k, k, q_offset=2), flash_sdpa_ref(q, k, k, q_offset=2))
    r = torch.from_numpy(rng.normal(0, 1, (1, 3, 2, 8)).astype(np.float32))
    s0 = torch.zeros(1, 2, 8, 8)
    got, want = wkv6(r, r, r, r.sigmoid(), r[0, 0], s0), wkv6_ref(r, r, r, r.sigmoid(), r[0, 0], s0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert flash_sdpa.launches == before  # CPU tensors never count a launch


def _flash_args():
    return torch.zeros(1, 4, 4, 32), torch.zeros(1, 4, 2, 32), torch.zeros(1, 4, 2, 32)


@pytest.mark.parametrize("case,err", [
    ("meta device", ValueError),
    ("mixed devices", ValueError),
    ("float16", TypeError),
    ("mixed dtypes", TypeError),
    ("head_dim 48", ValueError),
    ("heads not a multiple of kv heads", ValueError),
    ("rank 3", ValueError),
    ("non-contiguous", ValueError),
    ("negative offset", ValueError),
])
def test_flash_sdpa_refusals(case, err):
    q, k, v = _flash_args()
    if case == "meta device":
        q, k, v = (t.to("meta") for t in (q, k, v))
    elif case == "mixed devices":
        k = k.to("meta")
    elif case == "float16":
        q, k, v = (t.half() for t in (q, k, v))
    elif case == "mixed dtypes":
        k = k.bfloat16()
    elif case == "head_dim 48":
        q, k, v = torch.zeros(1, 4, 4, 48), torch.zeros(1, 4, 2, 48), torch.zeros(1, 4, 2, 48)
    elif case == "heads not a multiple of kv heads":
        k, v = torch.zeros(1, 4, 3, 32), torch.zeros(1, 4, 3, 32)
    elif case == "rank 3":
        q = q[0]
    elif case == "non-contiguous":
        q = torch.zeros(1, 4, 32, 4).transpose(2, 3)
    with pytest.raises(err):
        flash_sdpa(q, k, v, q_offset=-1 if case == "negative offset" else 0)


def _wkv_args():
    B, T, H, K = 1, 3, 2, 8
    return [torch.zeros(B, T, H, K) for _ in range(4)] + [torch.zeros(H, K), torch.zeros(B, H, K, K)]


@pytest.mark.parametrize("case,err", [
    ("meta device", ValueError),
    ("float16 inputs", TypeError),
    ("mixed r/k/v dtypes", TypeError),
    ("K = 12", ValueError),
    ("V = 256", ValueError),
    ("u shape", ValueError),
    ("s0 shape", ValueError),
    ("non-contiguous", ValueError),
])
def test_wkv6_refusals(case, err):
    r, k, v, w, u, s0 = _wkv_args()
    if case == "meta device":
        r = r.to("meta")
    elif case == "float16 inputs":
        r, k, v = r.half(), k.half(), v.half()
    elif case == "mixed r/k/v dtypes":
        v = v.bfloat16()
    elif case == "K = 12":
        r, k, w = (torch.zeros(1, 3, 2, 12) for _ in range(3))
        u, s0 = torch.zeros(2, 12), torch.zeros(1, 2, 12, 8)
    elif case == "V = 256":
        v, s0 = torch.zeros(1, 3, 2, 256), torch.zeros(1, 2, 8, 256)
    elif case == "u shape":
        u = torch.zeros(8)
    elif case == "s0 shape":
        s0 = torch.zeros(1, 2, 8, 4)
    elif case == "non-contiguous":
        r = torch.zeros(1, 3, 8, 2).transpose(2, 3)
    with pytest.raises(err):
        wkv6(r, k, v, w, u, s0)
