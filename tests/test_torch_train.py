"""The port's training substrate against ``repro``'s on the CPU: schedules,
AdamW, the ``.npz`` checkpoint format and the weight converters, the
estimator's loss and fit, the CNN reward model, and the detector's targets,
loss and training loop.  Both packages start from ``repro``'s initial
weights (carried over by ``repro_torch.convert``) and see the same numpy
batches.

Tolerances for training (CHANGES.md has the reasons):

* one step's loss and gradients are held at 1e-5 of each leaf's largest
  |g| (float32 summation order: XLA and PyTorch reduce in different orders);
* after N AdamW steps, parameters are held at ``2 * lr_sum`` with lr_sum the
  sum of the N steps' learning rates: m_hat / sqrt(v_hat) is ~±1 for any
  gradient above eps, so an element whose gradient is float32 noise near 0
  can move by up to lr a step on one side and -lr on the other.  The share
  of elements farther apart than 1e-5 is reported and held under a few
  percent.
"""
import numpy as np
import pytest
import torch

import repro.detection.batch  # noqa: F401  (first: repro's kernels import it back)
import jax
import jax.numpy as jnp
from repro.api import CNNRewardModel as JCNN
from repro.core import estimator as jest
from repro.data.shapes import ShapesDataset as JShapes
from repro.models import detector as jdet
from repro.train import checkpoint as jckpt
from repro.train import trainer as jtrainer
from repro.train.adamw import adamw_init as j_adamw_init
from repro.train.adamw import adamw_update as j_adamw_update
from repro.train.schedule import constant_schedule as j_constant
from repro.train.schedule import warmup_cosine as j_warmup_cosine

from repro_torch.api import CNNRewardModel, reward_model_from_state
from repro_torch.convert import (
    cnn_params_from_jax,
    cnn_params_to_jax,
    detector_params_from_jax,
    detector_params_to_jax,
    mlp_params_from_jax,
    mlp_params_to_jax,
)
from repro_torch.core import estimator as port_est
from repro_torch.data.shapes import ShapesDataset
from repro_torch.models import detector as tdet
from repro_torch.train import trainer as ttrainer
from repro_torch.train.adamw import adamw_init, adamw_update
from repro_torch.train.checkpoint import load_pytree, save_pytree
from repro_torch.train.schedule import constant_schedule, warmup_cosine

# reduced widths: the gradient and training tests stay fast on the CPU
J_TINY = jdet.DetectorConfig("tiny", widths=(4, 8, 8), head_width=8)
T_TINY = tdet.DetectorConfig("tiny", widths=(4, 8, 8), head_width=8)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def t2np(tree):
    return {k: t2np(v) if isinstance(v, dict) else v.detach().cpu().numpy() for k, v in tree.items()}


def assert_trees_close(got, want, atol, rtol=0.0):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            assert_trees_close(got[k], want[k], atol, rtol)
        else:
            np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=rtol, err_msg=k)


def leaf_pairs(got, want, prefix=""):
    for k in sorted(want):
        if isinstance(want[k], dict):
            yield from leaf_pairs(got[k], want[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(got[k]), np.asarray(want[k])


def hold_after_steps(got, want, lr_sum, max_share=0.01):
    """Parameters after N steps: every element within 2 * lr_sum, and the
    share of elements beyond 1e-5 under ``max_share``; returns that share."""
    far = total = 0
    for name, g, w in leaf_pairs(got, want):
        np.testing.assert_allclose(g, w, atol=2 * lr_sum, rtol=0, err_msg=name)
        far += int((np.abs(g - w) > 1e-5).sum())
        total += w.size
    assert far / total <= max_share, (far, total)
    return far / total


# ------------------------------------------------------------- schedules


@pytest.mark.parametrize("peak,warm,total", [(3e-3, 50, 500), (3e-3, 90, 900), (2e-3, 14, 280),
                                             (2e-3, 1, 3), (1e-3, 0, 10), (5e-4, 37, 1000)])
def test_warmup_cosine_equals_repro(peak, warm, total):
    """Warm-up steps equal exactly; cosine steps within 2 float32 ulps: XLA's
    float32 cosine is not correctly rounded and differs from the rounded
    double-precision cosine in the last place on ~1% of arguments."""
    j, t = j_warmup_cosine(peak, warm, total), warmup_cosine(peak, warm, total)
    want = np.array([np.float32(j(s)) for s in range(total + 3)], np.float32)
    got = np.array([t(s) for s in range(total + 3)], np.float32)
    np.testing.assert_array_equal(got[:warm], want[:warm])
    np.testing.assert_array_max_ulp(got, want, maxulp=2)
    assert (got == want).mean() > 0.97
    assert all(float(np.float32(v)) == v for v in map(t, range(5)))  # float32 values
    assert np.float32(j_constant(peak)(7)) == np.float32(constant_schedule(peak)(7))


# ----------------------------------------------------------------- AdamW


def _tree(rng, scale):
    return {"a": {"w": (rng.normal(size=(6, 5)) * scale).astype(np.float32),
                  "b": (rng.normal(size=5) * scale).astype(np.float32)},
            "c": (rng.normal(size=(3, 2, 2)) * scale).astype(np.float32)}


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])  # global norm under / over the clip
@pytest.mark.parametrize("weight_decay,grad_clip", [(0.01, 1.0), (1e-4, 1.0), (0.0, None)])
def test_adamw_update_equals_repro(grad_scale, weight_decay, grad_clip):
    rng = np.random.default_rng(int(grad_scale * 1000) + int(weight_decay * 1e4))
    p = _tree(rng, 1.0)
    jp, tp = jax.tree.map(jnp.asarray, p), jax.tree.map(torch.tensor, p)
    js, ts = j_adamw_init(jp), adamw_init(tp)
    for step in range(6):
        g = _tree(rng, grad_scale)
        lr = float(np.float32(1e-3 * (step + 1)))
        jp, js = j_adamw_update(jax.tree.map(jnp.asarray, g), js, jp, jnp.float32(lr),
                                weight_decay=weight_decay, grad_clip=grad_clip)
        tp, ts = adamw_update(jax.tree.map(torch.tensor, g), ts, tp, lr,
                              weight_decay=weight_decay, grad_clip=grad_clip)
    assert ts.step == int(js.step) == 6
    assert_trees_close(t2np(tp), np_tree(jp), atol=1e-6)
    assert_trees_close(t2np(ts.mu), np_tree(js.mu), atol=1e-6)
    assert_trees_close(t2np(ts.nu), np_tree(js.nu), atol=1e-6)
    if grad_clip is not None:  # the branch this case takes
        norm = np.sqrt(sum(float(np.sum(np.square(v))) for v in jax.tree.leaves(g)))
        assert (norm > grad_clip) == (grad_scale > 1)


def test_adamw_leaves_its_inputs_alone():
    rng = np.random.default_rng(0)
    p = jax.tree.map(torch.tensor, _tree(rng, 1.0))
    before = t2np(p)
    new, state = adamw_update(jax.tree.map(torch.tensor, _tree(rng, 1.0)), adamw_init(p), p, 0.1)
    assert_trees_close(t2np(p), before, atol=0)
    assert new["a"]["w"] is not p["a"]["w"] and state.step == 1


# ----------------------------------------------------- checkpoints, converters


def test_save_pytree_crosses_packages(tmp_path):
    """repro's key format ("['stage0_a']||['w']"): a file either package
    writes loads in the other, detector caches in repro's HWIO layout."""
    params = np_tree(jax.jit(jdet.detector_init, static_argnums=1)(jax.random.PRNGKey(1), J_TINY))
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save_pytree(jpath, params)
    det = tdet.Detector(T_TINY, device="cpu")
    det.load_state_dict(detector_params_from_jax(params))
    save_pytree(tpath, detector_params_to_jax(det.state_dict()))
    assert sorted(np.load(jpath).files) == sorted(np.load(tpath).files)
    assert "['stage0_a']||['w']" in np.load(tpath).files
    back = jckpt.load_pytree(tpath, params)
    assert_trees_close(np_tree(back), params, atol=0)
    like = {k: {kk: torch.zeros(v.shape, dtype=torch.float32) for kk, v in p.items()}
            for k, p in params.items()}
    assert_trees_close(t2np(load_pytree(jpath, like)), params, atol=0)
    mixed = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3), "b": {"c": np.ones(4, np.int32)}}
    save_pytree(tpath, mixed)
    got = jckpt.load_pytree(tpath, {"a": jnp.zeros((2, 3)), "b": {"c": jnp.zeros(4, jnp.int32)}})
    np.testing.assert_array_equal(got["a"], mixed["a"].numpy())
    assert got["b"]["c"].dtype == np.int32


def test_converters_round_trip():
    params = np_tree(jax.jit(jdet.detector_init, static_argnums=1)(jax.random.PRNGKey(2), J_TINY))
    assert_trees_close(detector_params_to_jax(detector_params_from_jax(params)), params, atol=0)
    mlp = np_tree(jest.mlp_init(jax.random.PRNGKey(3), 9, (7,)))
    assert_trees_close(mlp_params_to_jax(mlp_params_from_jax(mlp, device="cpu")), mlp, atol=0)
    cnn = np_tree(jest.cnn_init(jax.random.PRNGKey(4), 5, 4))
    port = cnn_params_from_jax(cnn, device="cpu")
    assert port["conv0"]["w"].shape == (4, 5, 3, 3) and port["head"]["w"].shape == (8, 1)
    assert_trees_close(cnn_params_to_jax(port), cnn, atol=0)
    assert port["conv1"]["w"].shape == cnn_init_shapes()["conv1"]


def cnn_init_shapes():
    p = port_est.cnn_init(torch.Generator().manual_seed(0), 5, 4)
    return {k: tuple(v["w"].shape) for k, v in p.items()}


# ------------------------------------------------------- reward estimators


def _regression(rng, n, f):
    x = rng.normal(0, 1, (n, f)).astype(np.float32)
    y = (1 / (1 + np.exp(-x[:, :3].sum(1)))).astype(np.float32)
    return x, y


@pytest.mark.parametrize("weighted,sigmoid_out", [(True, True), (False, True), (True, False)])
def test_weighted_mse_loss_and_grad(weighted, sigmoid_out):
    rng = np.random.default_rng(int(weighted) + 2 * int(sigmoid_out))
    x, y = _regression(rng, 64, 12)
    y[:5] = -0.2  # clipped to 0 by the weighting
    params = np_tree(jest.mlp_init(jax.random.PRNGKey(0), 12, (16, 8)))
    kw = dict(weighted=weighted, sigmoid_out=sigmoid_out)
    want, jg = jax.value_and_grad(jest.weighted_mse_loss)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(y), **kw)
    loss, grads = port_est.value_and_grad(
        lambda p, a, b: port_est.weighted_mse_loss(p, a, b, **kw),
        mlp_params_from_jax(params, device="cpu"), torch.tensor(x), torch.tensor(y))
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)
    for name, g, w in leaf_pairs(t2np(grads), np_tree(jg)):
        np.testing.assert_allclose(g, w, atol=1e-5 * np.abs(w).max(), rtol=0, err_msg=name)


@pytest.mark.parametrize("n,batch,epochs", [(300, 64, 3), (50, 64, 2)])  # n < batch: one step an epoch
def test_reward_estimator_fit(n, batch, epochs):
    """Same init, same standardize statistics, same permutation, same
    schedule: the loss traces and the weights after every step agree."""
    rng = np.random.default_rng(n)
    x, y = _regression(rng, n, 20)
    cfg = dict(hidden=(32,), epochs=epochs, batch_size=batch, lr=2e-3, seed=3)
    jest_ = jest.RewardEstimator(20, jest.EstimatorConfig(**cfg))
    port_model = port_est.RewardEstimator(20, port_est.EstimatorConfig(**cfg), device="cpu")
    port_model.params = mlp_params_from_jax(np_tree(jest_.params), device="cpu")
    jl = jest_.fit(x, y)
    tl = port_model.fit(x, y)
    np.testing.assert_array_equal(port_model._mu, jest_._mu)
    np.testing.assert_array_equal(port_model._sigma, jest_._sigma)
    assert len(tl) == len(jl) == epochs * max(n // batch, 1)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    steps = len(jl)
    sched = warmup_cosine(2e-3, max(steps // 20, 1), steps)
    hold_after_steps(t2np(port_model.params), np_tree(jest_.params), sum(map(sched, range(steps))))
    np.testing.assert_allclose(port_model.predict(x[:40]), jest_.predict(x[:40]), atol=1e-4)


def test_cnn_apply_equals_repro():
    rng = np.random.default_rng(4)
    fmap = rng.normal(0, 1, (5, 8, 7, 6)).astype(np.float32)  # odd width: SAME pads after
    params = np_tree(jest.cnn_init(jax.random.PRNGKey(5), 6, 4))
    want = np.asarray(jest.cnn_apply(jax.tree.map(jnp.asarray, params), jnp.asarray(fmap)))
    got = port_est.cnn_apply(cnn_params_from_jax(params, device="cpu"), torch.tensor(fmap))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_cnn_reward_model_fit(tmp_path):
    """Same init and minibatches (the last one short): loss traces and
    weights after the fit agree; the artifact state loads in either
    package."""
    rng = np.random.default_rng(6)
    fmap = rng.normal(0, 1, (70, 8, 8, 6)).astype(np.float32)
    y = rng.uniform(0, 1, 70).astype(np.float32)
    kw = dict(in_channels=6, width=4, epochs=3, batch_size=32, seed=1)
    jm, tm = JCNN(**kw), CNNRewardModel(**kw, device="cpu")
    tm.params = cnn_params_from_jax(np_tree(jm.params), device="cpu")
    jl, tl = jm.fit(fmap, y), tm.fit(fmap, y)
    assert len(tl) == len(jl) == 9
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    hold_after_steps(cnn_params_to_jax(tm.params), np_tree(jm.params), 9 * tm.lr)
    np.testing.assert_allclose(tm.predict(fmap), jm.predict(fmap), atol=1e-4)
    arrays, meta = tm.state()
    back = JCNN.from_state(arrays, meta)
    np.testing.assert_allclose(np.asarray(back.predict(fmap)), tm.predict(fmap), atol=1e-6)
    again = reward_model_from_state(*jm.state(), device="cpu")
    assert isinstance(again, CNNRewardModel) and not again.fused
    np.testing.assert_allclose(again.predict(fmap), jm.predict(fmap), atol=1e-6)


# -------------------------------------------------------------- detector


@pytest.fixture(scope="module")
def shapes():
    ds = ShapesDataset.generate(96, seed=3)
    jds = JShapes.generate(96, seed=3)
    np.testing.assert_array_equal(ds.images, jds.images)
    return ds, jds


def _batch(ds, n=24, seed=0):
    return next(ds.batches(n, np.random.default_rng(seed)))


def test_build_targets_exact(shapes):
    ds, jds = shapes
    for cfg in (tdet.WEAK, T_TINY):
        jcfg = jdet.WEAK if cfg is tdet.WEAK else J_TINY
        imgs, boxes, classes = _batch(ds, 64, seed=cfg.grid)
        _, jboxes, jclasses = _batch(jds, 64, seed=cfg.grid)
        got = tdet.build_targets(cfg, boxes, classes)
        want = jdet.build_targets(jcfg, jboxes, jclasses)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert got[0].sum() > 0


def _tiny_pair(seed):
    params = np_tree(jax.jit(jdet.detector_init, static_argnums=1)(jax.random.PRNGKey(seed), J_TINY))
    det = tdet.Detector(T_TINY, device="cpu")
    det.load_state_dict(detector_params_from_jax(params))
    return params, det


def test_detector_loss_and_grads(shapes):
    ds, _ = shapes
    params, det = _tiny_pair(7)
    imgs, boxes, classes = _batch(ds)
    targets = tdet.build_targets(T_TINY, boxes, classes)
    want, jg = jax.value_and_grad(jdet.detector_loss)(
        jax.tree.map(jnp.asarray, params), J_TINY, jnp.asarray(imgs),
        *(jnp.asarray(t) for t in targets))
    loss = tdet.detector_loss(det, imgs, *targets)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    grads = detector_params_to_jax({k: p.grad for k, p in det.named_parameters()})
    for name, g, w in leaf_pairs(grads, np_tree(jg)):
        np.testing.assert_allclose(g, w, atol=1e-5 * np.abs(w).max(), rtol=0, err_msg=name)


def test_detector_loss_tie_gradient():
    """At obj_logit == 0 the max(logit, 0) term splits its gradient ½/½ as
    jnp.maximum does (relu would give it all to one side)."""
    x = torch.zeros(3, requires_grad=True)
    torch.maximum(x, torch.zeros_like(x)).sum().backward()
    jg = jax.grad(lambda a: jnp.maximum(a, 0).sum())(jnp.zeros(3))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jg))


@pytest.mark.parametrize("steps", [6])
def test_train_detector_n_steps(shapes, monkeypatch, steps):
    """The same start (repro's init, substituted for the port's seeded
    draw), the same batches from ``default_rng(seed + 1)``: loss traces at
    1e-4 relative and the weights after N steps within 2 lr_sum."""
    ds, jds = shapes
    params, start = _tiny_pair(0)

    def from_repro(cfg, *, device, generator):
        det = tdet.Detector(cfg, device=device, generator=generator)
        det.load_state_dict(start.state_dict())
        return det

    monkeypatch.setattr(ttrainer, "Detector", from_repro)
    monkeypatch.setattr(jtrainer, "detector_init", lambda key, cfg: jax.tree.map(jnp.asarray, params))
    jp, jl = jtrainer.train_detector(J_TINY, jds, steps=steps, batch_size=32, seed=0, log_every=0)
    det, tl = ttrainer.train_detector(T_TINY, ds, steps=steps, batch_size=32, seed=0, log_every=0,
                                      device="cpu")
    assert len(tl) == len(jl) == steps  # three batches an epoch: a second pass over the data
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    sched = warmup_cosine(3e-3, max(steps // 10, 1), steps)
    hold_after_steps(detector_params_to_jax(det.state_dict()), np_tree(jp),
                     sum(map(sched, range(steps))))


def test_train_detector_reduces_loss(shapes):
    """The port's own check (as tests/test_train.py's for repro), at reduced
    width: the loss of the last steps is below the first steps'."""
    ds, _ = shapes
    det, losses = ttrainer.train_detector(T_TINY, ds, steps=30, batch_size=32, log_every=0,
                                          device="cpu")
    assert isinstance(det, tdet.Detector) and len(losses) == 30
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
