"""Shared inputs for the parity tests of the PyTorch port: the same numpy
arrays, made from a seed, for ``repro`` (JAX) and ``repro_torch``."""
import numpy as np

import repro.detection.batch  # noqa: F401  (first: repro's kernels import it back)
import jax
from repro.detection.map_engine import Detections as JDetections
from repro_torch.detection.map_engine import Detections as TDetections


def random_detection_arrays(rng, n_images, kmax, num_classes=8, frac_empty=0.2,
                            tie_levels=None, scale=1.0):
    """Ragged per-image (boxes, scores, classes) float32/int32 arrays;
    ``tie_levels`` quantizes the scores so that ties are common."""
    out = []
    for _ in range(n_images):
        n = 0 if rng.uniform() < frac_empty else int(rng.integers(1, kmax + 1))
        xy = rng.uniform(0, 0.8, (n, 2))
        wh = rng.uniform(0.01, 0.2, (n, 2))
        boxes = (np.concatenate([xy, xy + wh], 1) * scale).astype(np.float32)
        scores = rng.uniform(0, 1, n)
        if tie_levels:
            scores = np.round(scores * tie_levels) / tie_levels
        out.append((boxes, scores.astype(np.float32),
                    rng.integers(0, num_classes, n).astype(np.int32)))
    return out


def both_detections(arrays):
    """The same ragged arrays as each package's ``Detections`` list."""
    return ([JDetections(*a) for a in arrays], [TDetections(*a) for a in arrays])


def mlp_arrays(rng, F, H):
    """Seeded (w1, b1, w2, b2) for the estimator head."""
    return (
        rng.normal(0, 0.1, (F, H)).astype(np.float32),
        rng.normal(0, 0.1, H).astype(np.float32),
        rng.normal(0, 0.1, H).astype(np.float32),
        np.float32(0.05),
    )


def seeded_detector_tree(cfg, seed, objectness_bias=3.0, class_scale=6.0):
    """``repro.models.detector.detector_init`` weights as numpy, with the
    objectness bias raised and the class logits sharpened so that an
    untrained detector clears the 0.25 score threshold on many cells (the
    weights are seeded, not trained)."""
    import jax

    from repro.models.detector import detector_init

    init = jax.jit(detector_init, static_argnums=1)
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), cfg))
    head = {k: v.copy() for k, v in tree["head_out"].items()}
    head["b"][0] = objectness_bias
    head["w"][..., 1 : 1 + cfg.num_classes] *= class_scale
    tree["head_out"] = head
    return tree


# ------------------------------------------------- shared pipeline fixtures

import pytest  # noqa: E402


@pytest.fixture
def repro_init(monkeypatch):
    """The port's estimator starts from repro's draw for the same seed."""
    import jax

    from repro.core import estimator as jest
    from repro_torch.convert import mlp_params_from_jax
    from repro_torch.core import estimator as port_est

    def mlp_init(generator, in_dim, hidden=(128, 64)):
        key = jax.random.PRNGKey(generator.initial_seed())
        tree = jax.tree.map(np.asarray, jest.mlp_init(key, in_dim, hidden))
        return mlp_params_from_jax(tree, device="cpu")

    monkeypatch.setattr(port_est, "mlp_init", mlp_init)


@pytest.fixture
def repro_cnn_init(monkeypatch):
    """The port's CNN reward model starts from repro's draw for its seed."""
    import jax

    from repro.core import estimator as jest
    from repro_torch.api import reward_model as port_rm
    from repro_torch.convert import cnn_params_from_jax

    def cnn_init(generator, in_channels, width=16):
        key = jax.random.PRNGKey(generator.initial_seed())
        tree = jax.tree.map(np.asarray, jest.cnn_init(key, in_channels, width))
        return cnn_params_from_jax(tree, device="cpu")

    monkeypatch.setattr(port_rm, "cnn_init", cnn_init)


def detector_like(cfg):
    """The shapes of ``repro``'s detector pytree for ``cfg``."""
    import jax

    from repro.models.detector import detector_init

    return jax.eval_shape(lambda: detector_init(jax.random.PRNGKey(0), cfg))


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """repro's tiny pipeline, its 3-step detectors sharpened (objectness bias
    raised) so that they detect; then the port's, whose trainer runs too but
    whose detectors load repro's cached ``.npz`` weights: both packages
    score, match and featurize with the same trained parameters.  Returns
    (repro's state, the port's, the port's stage ms, the port's cache dir);
    repro's cache dir is its sibling ``repro``."""
    import jax
    import jax.numpy as jnp

    import repro.experiments.detection_repro as jdr
    import repro_torch.experiments.detection_repro as tdr
    from repro.train.checkpoint import load_pytree as j_load_pytree
    from repro_torch.convert import detector_params_from_jax

    base = tmp_path_factory.mktemp("pipelines")
    jdir, tdir = base / "repro", base / "port"  # repro's cache: tdir.parent / "repro"
    jdir.mkdir()
    tdir.mkdir()
    kw = dict(n_train=128, n_val=64, n_pool=64, steps_weak=3, steps_strong=3, force=True,
              verbose=False)
    real_j, real_t = jdr.train_detector, tdr.train_detector
    mp = pytest.MonkeyPatch()
    try:
        def j_train(cfg, ds, steps, seed):
            params, losses = real_j(cfg, ds, steps=steps, seed=seed, log_every=0)
            w, b = np.array(params["head_out"]["w"]), np.array(params["head_out"]["b"])
            w[..., 1 : 1 + cfg.num_classes] *= 6.0
            b[0] = 3.0
            return dict(params, head_out={"w": jnp.asarray(w), "b": jnp.asarray(b)}), losses

        def t_train(cfg, ds, steps, seed, device):
            det, losses = real_t(cfg, ds, steps=steps, seed=seed, log_every=0, device=device)
            like = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), detector_like(cfg))
            det.load_state_dict(detector_params_from_jax(
                j_load_pytree(str(jdir / f"detector_{cfg.name}.npz"), like)))
            return det, losses

        mp.setattr(jdr, "ARTIFACTS", str(jdir))
        mp.setattr(jdr, "train_detector", j_train)
        mp.setattr(tdr, "train_detector", t_train)
        jstate = jdr.build_pipeline(**kw)
        stage = {}
        tstate = tdr.build_pipeline(**kw, device="cpu", cache_dir=str(tdir), stage_ms=stage)
    finally:
        mp.undo()
    return jstate, tstate, stage, tdir


def port_evals(ev):
    """A ``repro`` ``ImageEval`` as the port's, field by field."""
    from repro_torch.detection.map_engine import ImageEval

    return ImageEval(
        per_class={c: (s.copy(), tp.copy()) for c, (s, tp) in ev.per_class.items()},
        gt_counts=dict(ev.gt_counts),
        matched_gt={c: m.copy() for c, m in ev.matched_gt.items()},
    )


def port_state(jstate):
    """``repro``'s ``PipelineState`` as the port's: the same evaluations,
    detections, ground truth, mAPs and features, so that the host numpy of
    both packages sees identical inputs."""
    from repro_torch.core.reward import MatchedImage
    from repro_torch.detection.map_engine import Detections, GroundTruth
    from repro_torch.experiments.detection_repro import PipelineState

    def dets(ds):
        return [Detections(d.boxes.copy(), d.scores.copy(), d.classes.copy()) for d in ds]

    return PipelineState(
        val_pairs=[MatchedImage(weak=port_evals(p.weak), strong=port_evals(p.strong))
                   for p in jstate.val_pairs],
        pool_weak_evals=[port_evals(e) for e in jstate.pool_weak_evals],
        weak_dets_val=dets(jstate.weak_dets_val),
        strong_dets_val=dets(jstate.strong_dets_val),
        val_gts=[GroundTruth(g.boxes.copy(), g.classes.copy()) for g in jstate.val_gts],
        weak_map=jstate.weak_map,
        strong_map=jstate.strong_map,
        features_val=np.array(jstate.features_val),
        image_size=jstate.image_size,
    )


def perturbed(tree, seed, scale=0.02):
    """A numpy copy of a JAX pytree with N(0, scale) added to every leaf, so
    that biases, norm scales and the RWKV6 bonus are not trivially 0 or 1."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a, np.float32) + rng.normal(0, scale, a.shape)).astype(np.float32),
        tree,
    )


def grid_positions(B, S, prefix, width):
    """(3, B, S) M-RoPE ids: the first ``prefix`` positions a grid of rows of
    ``width`` (t = 0, h = row, w = column), the rest text (t = h = w) going
    on from the grid's largest id + 1, as Qwen2-VL numbers them."""
    p = np.zeros((3, B, S), np.int32)
    cells = np.arange(prefix)
    p[1, :, :prefix], p[2, :, :prefix] = cells // width, cells % width
    start = max(prefix // width, width) if prefix else 0
    p[:, :, prefix:] = start + np.arange(S - prefix)
    return p


def modality_fields(cfg, B, S, seed):
    """A batch's fields besides tokens: for the VLM family a seeded vision
    prefix (``vision_patch_embeddings``) and M-RoPE ids with a grid of rows
    of 4 on it (the reduced configs' 8 vision tokens: 2 x 4); for the
    encoder-decoder family seeded ``audio_frame_embeddings`` (B,
    encoder_frames, d_model); nothing for the other families."""
    from repro_torch.data.modality_stubs import audio_frame_embeddings, vision_patch_embeddings

    rng = np.random.default_rng(seed)
    if cfg.arch_type == "vlm":
        return {"vision_embeds": vision_patch_embeddings(rng, B, cfg.vision_tokens, cfg.d_model),
                "positions_3d": grid_positions(B, S, cfg.vision_tokens, 4)}
    if cfg.arch_type == "encdec":
        return {"audio_frames": audio_frame_embeddings(rng, B, cfg.encoder_frames, cfg.d_model)}
    return {}
