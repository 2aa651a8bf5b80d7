"""LM training in the port against the JAX package's, on the CPU: ``loss_fn``,
its gradients, ``make_train_step`` over N steps, remat, the kernels'
autograd Functions, and the training launcher, for the dense, RWKV6, MoE
(with and without MLA; the MoE aux loss in the loss and its gradients), VLM
(a vision prefix and M-RoPE ids in every batch), hybrid (autograd through
the chunked Mamba2 scan, remat a group) and encoder-decoder (audio frames in
every batch, remat each encoder and decoder layer) families; and the
launcher's ``--dryrun`` report.

Weights are drawn by ``repro`` (perturbed from numpy, so that biases, norm
scales and the RWKV6 bonus are not trivially 0 or 1) and carried into the
port as float32 leaves by ``lm_params_from_jax(..., dtype=torch.float32)``.
Tolerances (those of ``tests/test_torch_train.py``, CHANGES.md PR 16): the
loss at 1e-5 relative, each gradient leaf at 1e-5 of its largest |g|, and
parameters after N AdamW steps within 2 lr_sum with at most 1% of elements
beyond 1e-5.  On the CPU the kernels' Functions differentiate the same plain
versions as plain autograd, and remat recomputes the same ops: both are held
bit for bit."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from _torch_parity import perturbed, modality_fields  # first: it imports repro.detection before repro's kernels
import jax
import jax.numpy as jnp
from repro.configs import get_config as j_get_config
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import lm as jlm
from repro.train.adamw import adamw_init as j_adamw_init
from repro.train.checkpoint import load_pytree as j_load_pytree

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.core.estimator import value_and_grad
from repro_torch.data.lm_synth import synth_lm_batch
from repro_torch.kernels.flash_sdpa import flash_sdpa, flash_sdpa_ref
from repro_torch.kernels.wkv6 import wkv6, wkv6_ref
from repro_torch.launch import train as launcher
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm as tlm
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.train.adamw import adamw_init

ARCHS = ["qwen2_7b", "yi_6b", "rwkv6_1b6", "deepseek_moe_16b", "deepseek_v2_lite_16b",
         "qwen2_vl_2b", "zamba2_2b7", "whisper_base"]
B, S = 2, 16
STEPS, LR = 3, 1e-3


def lm_batch(cfg, seed):
    """synth_lm_batch's tokens and labels, a few more labels set to -1."""
    rng = np.random.default_rng(seed)
    toks, labels = synth_lm_batch(rng, B, S, cfg.vocab_size)
    labels[rng.uniform(size=labels.shape) < 0.2] = -1
    return toks, labels


def leaf_pairs(got, want, prefix=""):
    for k in sorted(want):
        if isinstance(want[k], dict):
            yield from leaf_pairs(got[k], want[k], f"{prefix}{k}/")
        else:
            g = got[k]
            yield f"{prefix}{k}", (g.detach().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)), \
                np.asarray(want[k])


@pytest.fixture(scope="module")
def models():
    """Per arch: (repro cfg, repro params, port cfg, float32 port params)."""
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg, tcfg = jlm.reduced(j_get_config(arch)), tlm.reduced(get_config(arch))
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        tree = perturbed(jax.jit(jlm.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(i)),
                         seed=200 + i)
        tparams = lm_params_from_jax(tree, tcfg, device="cpu", dtype=torch.float32)
        out[arch] = (jcfg, jax.tree.map(jnp.asarray, tree), tcfg, tparams)
    return out


def both_batches(cfg, seed):
    toks, labels = lm_batch(cfg, seed)
    batch = {"tokens": toks, "labels": labels, **modality_fields(cfg, B, S, seed)}
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def port_grads(params, cfg, batch, plain=False):
    with torch.enable_grad():
        return value_and_grad(lambda p, c, b: tlm.loss_fn(p, c, b, plain=plain), params, cfg, batch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_repro(models, arch):
    jcfg, jparams, tcfg, tparams = models[arch]
    jb, tb = both_batches(tcfg, 1)
    assert int((tb["labels"] < 0).sum()) > B  # the last position and some more
    want = float(jlm.loss_fn(jparams, jcfg, jb))
    got = tlm.loss_fn(tparams, tcfg, tb)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_loss_fn_ignores_negative_labels_and_all_masked(models):
    _, _, tcfg, tparams = models["yi_6b"]
    toks, labels = lm_batch(tcfg, 2)
    full = tlm.loss_fn(tparams, tcfg, {"tokens": toks, "labels": labels})
    logits = tlm.forward(tparams, tcfg, {"tokens": toks})[0].double()
    valid = labels >= 0
    nll = torch.logsumexp(logits, -1) - logits.gather(
        -1, torch.from_numpy(np.maximum(labels, 0)).long()[..., None])[..., 0]
    np.testing.assert_allclose(float(full), float(nll[torch.from_numpy(valid)].mean()), rtol=1e-5)
    none = tlm.loss_fn(tparams, tcfg, {"tokens": toks, "labels": np.full_like(labels, -1)})
    assert float(none) == 0.0  # nothing valid: 0 / max(0, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_repro(models, arch):
    jcfg, jparams, tcfg, tparams = models[arch]
    jb, tb = both_batches(tcfg, 3)
    want, jg = jax.value_and_grad(jlm.loss_fn)(jparams, jcfg, jb)
    loss, grads = port_grads(tparams, tcfg, tb)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    n = 0
    for name, g, w in leaf_pairs(grads, jax.tree.map(np.asarray, jg)):
        assert g.shape == w.shape and g.dtype == np.float32, name
        np.testing.assert_allclose(g, w, atol=1e-5 * np.abs(w).max(), rtol=0, err_msg=name)
        n += 1
    assert n == len(list(tree_leaves(tparams)))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_repro(models, arch):
    """N steps of make_train_step from one start on the same batches: the
    losses at 1e-5 relative, the parameters within 2 lr_sum."""
    jcfg, jparams, tcfg, tparams = models[arch]
    jstep = jax.jit(j_make_train_step(jcfg, lr=LR))
    tstep = make_train_step(tcfg, lr=LR)
    jopt, topt = j_adamw_init(jparams), adamw_init(tparams)
    start = tree_map(torch.clone, tparams)
    for i in range(STEPS):
        jb, tb = both_batches(tcfg, 10 + i)
        jparams, jopt, jloss = jstep(jparams, jopt, jb)
        tparams, topt, tloss = tstep(tparams, topt, tb)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert topt.step == STEPS
    far = total = 0
    for name, g, w in leaf_pairs(tparams, jax.tree.map(np.asarray, jparams)):
        np.testing.assert_allclose(g, w, atol=2 * STEPS * LR, rtol=0, err_msg=name)
        far += int((np.abs(g - w) > 1e-5).sum())
        total += w.size
    assert far <= 0.01 * total, (far, total)
    # functional: the start is left as it was
    for a, b in zip(tree_leaves(start), tree_leaves(models[arch][3])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_lowers_the_loss(models, arch):
    """tests/test_archs_smoke.py::test_one_train_step on the port."""
    _, _, tcfg, tparams = models[arch]
    _, tb = both_batches(tcfg, 4)
    l0 = float(tlm.loss_fn(tparams, tcfg, tb))
    params, _, loss = make_train_step(tcfg, lr=1e-3)(tparams, adamw_init(tparams), tb)
    assert float(loss) == pytest.approx(l0, rel=1e-6) and np.isfinite(float(loss))
    assert float(tlm.loss_fn(params, tcfg, tb)) < l0


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_bit_equal_gradients(models, arch):
    _, _, tcfg, tparams = models[arch]
    _, tb = both_batches(tcfg, 5)
    assert tcfg.remat
    on = port_grads(tparams, tcfg, tb)
    off = port_grads(tparams, dataclasses.replace(tcfg, remat=False), tb)
    assert torch.equal(on[0], off[0])
    for a, b in zip(tree_leaves(on[1]), tree_leaves(off[1])):
        assert torch.equal(a, b)


def test_remat_checkpoints_only_when_training(models, monkeypatch):
    """Serving (no parameter requires grad, or no grad mode) runs each layer
    once; training runs it again in the backward pass (a hybrid: each group,
    its Mamba2 layers and its shared block)."""
    _, _, tcfg, tparams = models["yi_6b"]
    _, tb = both_batches(tcfg, 6)
    calls = []
    block = tlm._dense_block
    monkeypatch.setattr(tlm, "_dense_block", lambda *a, **k: calls.append(1) or block(*a, **k))
    tlm.forward(tparams, tcfg, tb)
    with torch.no_grad():
        tlm.loss_fn(tparams, tcfg, tb)
    assert len(calls) == 2 * tcfg.num_layers
    calls.clear()
    port_grads(tparams, tcfg, tb)
    assert len(calls) == 2 * tcfg.num_layers  # forward + recompute
    calls.clear()
    mamba = tlm._mamba_block
    monkeypatch.setattr(tlm, "_mamba_block", lambda *a, **k: calls.append(0) or mamba(*a, **k))
    _, _, hcfg, hparams = models["zamba2_2b7"]
    port_grads(hparams, hcfg, both_batches(hcfg, 6)[1])
    assert calls.count(0) == 2 * hcfg.num_mamba_layers  # the shared block: 1s
    assert calls.count(1) == 2 * hcfg.num_shared_attn


@pytest.mark.parametrize("arch", ARCHS)
def test_function_path_bit_equal_to_plain_autograd(models, arch):
    """The model's gradients through the kernels' Functions (on the CPU:
    the plain forward, the plain version differentiated in backward) equal
    plain autograd's (plain=True) bit for bit."""
    _, _, tcfg, tparams = models[arch]
    _, tb = both_batches(tcfg, 7)
    fn = port_grads(tparams, tcfg, tb)
    plain = port_grads(tparams, tcfg, tb, plain=True)
    assert torch.equal(fn[0], plain[0])
    for a, b in zip(tree_leaves(fn[1]), tree_leaves(plain[1])):
        assert torch.equal(a, b)


def _leaves(rng, *shapes):
    return [torch.tensor(rng.normal(0, 1, s).astype(np.float32), requires_grad=True) for s in shapes]


@pytest.mark.parametrize("window,q_offset,causal", [(0, 0, True), (4, 0, True), (0, 3, True),
                                                     (0, 0, False), (3, 12, True)])
def test_flash_sdpa_function_bit_equal_to_plain(window, q_offset, causal):
    rng = np.random.default_rng(window + q_offset)
    q, k, v = _leaves(rng, (2, 7, 4, 32), (2, 9, 2, 32), (2, 9, 2, 32))
    g = torch.tensor(rng.normal(0, 1, (2, 7, 4, 32)).astype(np.float32))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out = flash_sdpa(q, k, v, **kw)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "_FlashSdpaGradBackward"
    ref = flash_sdpa_ref(q, k, v, **kw)
    assert torch.equal(out, ref)
    want = torch.autograd.grad(ref, (q, k, v), g)
    for a, b in zip(torch.autograd.grad(out, (q, k, v), g), want):
        assert torch.equal(a, b)
    # only the inputs that require grad get one
    kd = k.detach()
    gq, gv = torch.autograd.grad(flash_sdpa(q, kd, v, **kw), (q, v), g)
    assert torch.equal(gq, want[0]) and torch.equal(gv, want[2])


def test_flash_sdpa_masked_rows_give_zero_gradient():
    """A row that sees no key (window past the last key) gives 0 forward and
    a gradient of 0, not NaN, to q, k and v."""
    rng = np.random.default_rng(0)
    q, k, v = _leaves(rng, (1, 4, 2, 32), (1, 6, 2, 32), (1, 6, 2, 32))
    out = flash_sdpa(q, k, v, window=2, q_offset=10)  # keys 9, 10 are not there
    assert torch.equal(out, torch.zeros_like(out))
    grads = torch.autograd.grad(out.square().sum() + out.sum(), (q, k, v))
    for gr in grads:
        assert torch.equal(gr, torch.zeros_like(gr))
    # a mix: rows at 4 and 5 see two keys, 6 one (key 5), 7 none
    out = flash_sdpa(q, k, v, window=2, q_offset=4)
    gq, gk, gv = torch.autograd.grad(out.square().sum(), (q, k, v))
    assert torch.isfinite(gq).all() and torch.isfinite(gk).all() and torch.isfinite(gv).all()
    assert torch.equal(gq[:, 3], torch.zeros_like(gq[:, 3])) and (gq[:, :2].abs() > 0).all()


@pytest.mark.parametrize("which", ["out", "state", "both"])
def test_wkv6_function_bit_equal_to_plain(which):
    """Gradients to r, k, v, w, u and s0, for a gradient of out, of sT or of
    both (an unused sT passes None, not zeros)."""
    rng = np.random.default_rng(1)
    r, k, v = _leaves(rng, (2, 6, 2, 8), (2, 6, 2, 8), (2, 6, 2, 8))
    w = torch.tensor(rng.uniform(0.5, 0.99, (2, 6, 2, 8)).astype(np.float32), requires_grad=True)
    u, s0 = _leaves(rng, (2, 8), (2, 2, 8, 8))
    ins = (r, k, v, w, u, s0)
    gout = torch.tensor(rng.normal(0, 1, (2, 6, 2, 8)).astype(np.float32))
    gst = torch.tensor(rng.normal(0, 1, (2, 2, 8, 8)).astype(np.float32))

    def grads(fn):
        out, st = fn(*ins)
        outs, gs = {"out": ([out], [gout]), "state": ([st], [gst]),
                    "both": ([out, st], [gout, gst])}[which]
        got = torch.autograd.grad(outs, ins, gs, allow_unused=True)  # sT does not depend on r
        return [torch.zeros_like(x) if g is None else g for x, g in zip(ins, got)]

    for a, b in zip(grads(wkv6), grads(wkv6_ref)):
        assert torch.equal(a, b)
    out, st = wkv6(*ins)
    assert type(out.grad_fn).__name__ == "_Wkv6GradBackward"
    with torch.no_grad():
        assert wkv6(*ins)[0].grad_fn is None


@pytest.mark.parametrize("dtype", [None, torch.float32])
def test_init_params_keeps_float32_leaves_for_training(dtype):
    cfg = dataclasses.replace(tlm.reduced(get_config("qwen2_7b")), dtype="bfloat16")
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=dtype)
    want = dtype or torch.bfloat16
    assert {t.dtype for t in tree_leaves(params)} == {want}
    logits, _ = tlm.forward(params, cfg, {"tokens": np.zeros((1, 4), np.int32)})
    assert logits.dtype == torch.bfloat16  # computes in the activation type either way


def test_bf16_compute_over_float32_params_trains(models):
    """The card's setup on the CPU: bf16 activations, float32 leaves, remat."""
    _, _, tcfg, tparams = models["qwen2_7b"]
    cfg = dataclasses.replace(tcfg, dtype="bfloat16")
    _, tb = both_batches(cfg, 8)
    params, _, loss = make_train_step(cfg, lr=1e-3)(tparams, adamw_init(tparams), tb)
    assert {t.dtype for t in tree_leaves(params)} == {torch.float32}
    assert float(tlm.loss_fn(params, cfg, tb)) < float(loss)


@pytest.mark.parametrize("arch", ["yi_6b", "rwkv6_1b6", "deepseek_v2_lite_16b", "qwen2_vl_2b",
                                  "zamba2_2b7", "whisper_base"])
def test_launcher_trains_and_repro_reads_its_checkpoint(tmp_path, arch):
    path = str(tmp_path / f"{arch}.npz")
    params, losses = launcher.main(["--arch", arch, "--steps", "2", "--batch", "2", "--seq", "16",
                                    "--device", "cpu", "--ckpt", path])
    assert len(losses) == 2 and all(np.isfinite(losses))
    jcfg = jlm.reduced(j_get_config(arch))
    like = jax.eval_shape(lambda key: jlm.init_params(jcfg, key), jax.random.PRNGKey(0))
    loaded = j_load_pytree(path, jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), like))
    for name, g, w in leaf_pairs(params, loaded):
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("arch", ["yi_6b", "whisper_base"])
def test_launcher_dryrun_prints_the_report(arch, capsys):
    """``--dryrun`` trains nothing: it prints the single-card report of the
    full-size arch at train_4k (launch.dryrun), read against the data sheet
    on a host without a card."""
    rep, losses = launcher.main(["--arch", arch, "--dryrun", "--device", "cpu"])
    assert losses == []
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rep
    assert (rep["arch"], rep["shape"], rep["kind"]) == (arch, "train_4k", "train")
    assert rep["card"]["memory_source"] == rep["card"]["rates_source"] == "NVIDIA H100 SXM data sheet"
    assert rep["argument_bytes"]["opt_state"] == 2 * rep["argument_bytes"]["params"] + 8
