"""The port's kernels against ``repro``'s Pallas kernels (interpret mode) on
the CPU, where each wrapper takes its plain PyTorch version; plus the
dispatch rules and the wrappers' input checks.  ``test_torch_cuda.py`` holds
the CUDA kernels against the same plain versions on a card."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from _torch_parity import both_detections, mlp_arrays, random_detection_arrays

from repro.detection.batch import DetectionsBatch as JBatch
from repro.kernels.estimator_mlp import estimator_mlp as j_mlp
from repro.kernels.iou_matrix import iou_matrix as j_iou, iou_matrix_batch as j_iou_batch
from repro.kernels.score_pipeline import score_pipeline as j_score
from repro_torch.detection.batch import DetectionsBatch as TBatch
from repro_torch.kernels.dispatch import resolve_device, resolve_path
from repro_torch.kernels.estimator_mlp import estimator_mlp
from repro_torch.kernels.iou_matrix import iou_matrix, iou_matrix_batch
from repro_torch.kernels.score_pipeline import score_pipeline

NUM_CLASSES = 8
TOP_K = 25
_DTYPES = {"float32": (jnp.float32, torch.float32, 1e-6), "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def boxes(rng, shape):
    b = rng.uniform(0, 50, shape + (2,))
    return np.concatenate([b, b + rng.uniform(1, 20, shape + (2,))], -1).astype(np.float32)


def as_np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("n,m", [(1, 1), (7, 300), (256, 256), (511, 130), (1024, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_iou_matrix_matches_pallas(n, m, dtype, rng):
    jdt, tdt, tol = _DTYPES[dtype]
    a, b = boxes(rng, (n,)), boxes(rng, (m,))
    want = j_iou(jnp.asarray(a, jdt), jnp.asarray(b, jdt), interpret=True)
    got = iou_matrix(torch.tensor(a).to(tdt), torch.tensor(b).to(tdt))
    assert got.dtype == tdt and got.shape == (n, m)
    np.testing.assert_allclose(as_np(got), as_np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,K,M", [(1, 1, 1), (3, 7, 5), (8, 64, 8), (5, 20, 13), (17, 9, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_iou_matrix_batch_matches_pallas(B, K, M, dtype, rng):
    jdt, tdt, tol = _DTYPES[dtype]
    a, b = boxes(rng, (B, K)), boxes(rng, (B, M))
    want = j_iou_batch(jnp.asarray(a, jdt), jnp.asarray(b, jdt), tile_b=8,
                       tile_n=8 * -(-K // 8), tile_m=8 * -(-M // 8), interpret=True)
    got = iou_matrix_batch(torch.tensor(a).to(tdt), torch.tensor(b).to(tdt))
    assert got.dtype == tdt and got.shape == (B, K, M)
    np.testing.assert_allclose(as_np(got), as_np(want), atol=tol, rtol=tol)


def test_iou_batch_is_per_image_iou(rng):
    a, b = torch.tensor(boxes(rng, (4, 6))), torch.tensor(boxes(rng, (4, 3)))
    out = iou_matrix_batch(a, b)
    for i in range(4):
        torch.testing.assert_close(out[i], iou_matrix(a[i], b[i]), rtol=0, atol=0)


@pytest.mark.parametrize("B,F,H", [(1, 10, 8), (37, 395, 96), (128, 387, 128), (5, 33, 17), (300, 100, 64)])
def test_estimator_mlp_matches_pallas(B, F, H, rng):
    x = rng.normal(0, 1, (B, F)).astype(np.float32)
    w1, b1, w2, b2 = mlp_arrays(rng, F, H)
    want = j_mlp(*(jnp.asarray(v) for v in (x, w1, b1, w2, b2)), interpret=True)
    got = estimator_mlp(*(torch.tensor(v) for v in (x, w1, b1, w2, b2)))
    assert got.shape == (B,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_estimator_mlp_empty_batch(rng):
    w1, b1, w2, b2 = (torch.tensor(v) for v in mlp_arrays(rng, 387, 128))
    out = estimator_mlp(torch.zeros((0, 387)), w1, b1, w2, b2)
    assert out.shape == (0,) and out.dtype == torch.float32


def _score_inputs(rng, B, kmax, tie_levels=None, frac_empty=0.2):
    arrays = random_detection_arrays(rng, B, kmax, NUM_CLASSES, frac_empty, tie_levels)
    jd, td = both_detections(arrays)
    F = TOP_K * (7 + NUM_CLASSES) + 4 + NUM_CLASSES
    w1, b1, w2, b2 = mlp_arrays(rng, F, 128)
    mu = rng.normal(0, 0.1, F).astype(np.float32)
    sigma = rng.uniform(0.5, 2.0, F).astype(np.float32)
    params = dict(w1=w1, b1=b1, w2=w2, b2=b2, mu=mu, sigma=sigma)
    return JBatch.from_list(jd), TBatch.from_list(td, device="cpu"), params


@pytest.mark.parametrize(
    "B,kmax,ties,frac_empty",
    [(1, 12, None, 0.0), (7, 40, None, 0.2), (64, 12, None, 0.2), (40, 64, 4, 0.1),
     (5, 3, None, 0.0), (6, 30, None, 1.0), (33, 25, 2, 0.3)],
)
@pytest.mark.parametrize("path", ["lax", "pallas_interpret"])
def test_score_pipeline_matches_repro(B, kmax, ties, frac_empty, path, rng):
    """K < top_k (kmax 3, 12), tied scores (ties), all-padded rows
    (frac_empty 1.0) and several image tiles, against both repro paths."""
    jb, tb, p = _score_inputs(rng, B, kmax, ties, frac_empty)
    kw = dict(num_classes=NUM_CLASSES, top_k=TOP_K, image_size=1.0)
    want = np.asarray(j_score(jb, {k: jnp.asarray(v) for k, v in p.items()}, path=path, **kw))
    got = score_pipeline(tb, {k: torch.tensor(v) for k, v in p.items()}, **kw)
    assert got.shape == (B,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)


def test_score_pipeline_empty_batch(rng):
    _, tb, p = _score_inputs(rng, 3, 10)
    empty = TBatch.from_list([], device="cpu")
    out = score_pipeline(empty, {k: torch.tensor(v) for k, v in p.items()},
                         num_classes=NUM_CLASSES, top_k=TOP_K)
    assert out.shape == (0,) and out.dtype == torch.float32


def test_score_pipeline_feature_dim_mismatch_raises(rng):
    _, tb, p = _score_inputs(rng, 3, 10)
    with pytest.raises(ValueError, match="features"):
        score_pipeline(tb, {k: torch.tensor(v) for k, v in p.items()},
                       num_classes=NUM_CLASSES + 1, top_k=TOP_K)


def test_resolve_path_follows_the_device():
    cpu = torch.zeros(3)
    assert resolve_path(cpu) == "reference"
    assert resolve_path(cpu, "reference") == "reference"
    with pytest.raises(ValueError, match="compiled"):
        resolve_path(cpu, "compiled")
    with pytest.raises(ValueError, match="unknown"):
        resolve_path(cpu, "interpret")


def test_resolve_device_refuses_missing_gpu():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")
        with pytest.raises(RuntimeError, match="cuda"):
            TBatch.from_list([])  # entry points default to the card


def test_wrappers_check_inputs(rng):
    a = torch.tensor(boxes(rng, (6,)))
    with pytest.raises(ValueError, match="contiguous"):
        iou_matrix(a.t().contiguous().t(), a)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        iou_matrix(a.double(), a.double())
    with pytest.raises(ValueError, match="batch size"):
        iou_matrix_batch(a[None].repeat(2, 1, 1), a[None])
    w1, b1, w2, b2 = (torch.tensor(v) for v in mlp_arrays(rng, 10, 4))
    with pytest.raises(ValueError, match="x must be"):
        estimator_mlp(torch.zeros((3, 11)), w1, b1, w2, b2)
    with pytest.raises(ValueError, match="b1 must have shape"):
        estimator_mlp(torch.zeros((3, 10)), w1, b1[:3], w2, b2)


def test_cpu_calls_never_count_launches(rng):
    before = (iou_matrix.launches, iou_matrix_batch.launches,
              estimator_mlp.launches, score_pipeline.launches)
    a = torch.tensor(boxes(rng, (2, 5)))
    iou_matrix(a[0], a[1])
    iou_matrix_batch(a, a)
    w1, b1, w2, b2 = (torch.tensor(v) for v in mlp_arrays(rng, 10, 4))
    estimator_mlp(torch.zeros((3, 10)), w1, b1, w2, b2)
    after = (iou_matrix.launches, iou_matrix_batch.launches,
             estimator_mlp.launches, score_pipeline.launches)
    assert before == after
