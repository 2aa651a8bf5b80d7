"""Shared inputs for the parity tests of the PyTorch port: the same numpy
arrays, made from a seed, for ``repro`` (JAX) and ``repro_torch``."""
import numpy as np

import repro.detection.batch  # noqa: F401  (first: repro's kernels import it back)
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
