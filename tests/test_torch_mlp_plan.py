"""The reward head's launch plan (``mlp_plan``) and its summation order, on
the CPU.

``mlp_plan`` decides how ``kernels/csrc/mlp.cuh`` splits a head over a
thread block cluster; the checks here are the invariants the kernel relies
on.  ``emulate_head`` repeats the kernel's float32 summation order in plain
torch (per-rank slice partials, each the sum of its F-chunks in chunk
order, summed in rank order; each rank's share of the hidden units; the
ranks' row sums in rank order) and is held against
the plain versions and ``repro``'s kernels at the tolerances of the card
checks (1e-5 for the MLP, 2e-6 for the score pipeline)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as Fn

import jax.numpy as jnp
from _torch_parity import both_detections, mlp_arrays, random_detection_arrays

from repro.detection.batch import DetectionsBatch as JBatch
from repro.kernels.estimator_mlp import estimator_mlp as j_mlp
from repro.kernels.score_pipeline import score_pipeline as j_score
from repro_torch.core.features import box_feature_stack, pad_box_axis
from repro_torch.detection.batch import DetectionsBatch as TBatch
from repro_torch.kernels.estimator_mlp import estimator_mlp, estimator_mlp_ref
from repro_torch.kernels.estimator_mlp.ops import (
    H100_CLUSTERS, MAX_CLUSTER, SMEM_LIMIT, SMS, TILE_ROWS, mlp_plan, shard_plan, slice_start,
)
from repro_torch.kernels.score_pipeline import score_pipeline, score_pipeline_ref
from repro_torch.kernels.score_pipeline.ops import pipeline_scratch

NUM_CLASSES, TOP_K = 8, 25
F_DET = TOP_K * (7 + NUM_CLASSES) + 4 + NUM_CLASSES  # 387

# (B, F, H, full_rows): the five main-path launches (estimator_mlp at
# calibration, at decide(features=...) and in the LM cascade; score_pipeline
# at a request and at a single frame), then the corners
MAIN = [(512, F_DET, 128, False), (64, F_DET, 128, False), (8, 12, 64, False),
        (64, F_DET, 128, True), (1, F_DET, 128, True)]
CORNERS = [(1, 1, 1, False), (9, 33, 17, False), (4096, F_DET, 128, False),
           (4096, F_DET, 128, True), (37, 203, 65, False), (5, 700, 300, False),
           (4096, 700, 300, False), (300, 4096, 1024, False), (2, 5, 3, False)]


def plan_of(B, F, H, full_rows):
    return mlp_plan(B, F, H, full_rows=full_rows,
                    **(pipeline_scratch(64, TOP_K, F) if full_rows else {}))


@pytest.mark.parametrize("B,F,H,full_rows", MAIN + CORNERS)
def test_plan_invariants(B, F, H, full_rows):
    p = plan_of(B, F, H, full_rows)
    assert p.cs in (1, 2, 4, 8) and p.cs <= MAX_CLUSTER
    assert p.grid % p.cs == 0 and p.cs <= p.grid <= SMS
    assert p.tb in TILE_ROWS and p.tiles == -(-B // p.tb)
    assert p.grid // p.cs <= p.tiles  # no cluster without a tile
    assert p.smem <= SMEM_LIMIT
    # F covered exactly once, every boundary but the last at a multiple of 4
    # rows, so each slice of W1 starts 16-byte aligned; no rank is empty
    b = p.bounds
    assert len(b) == p.cs + 1 and b[0] == 0 and b[-1] == F
    assert all(lo < hi for lo, hi in zip(b, b[1:]))
    assert all(x % 4 == 0 and (x * H * 4) % 16 == 0 for x in b[:-1])
    assert b == tuple(slice_start(F, p.cs, r) for r in range(p.cs + 1))
    # every slice but the last is a multiple of 16 bytes: one bulk copy
    assert all(((hi - lo) * H * 4) % 16 == 0 for lo, hi in zip(b[:-2], b[1:-1]))
    widest = max(hi - lo for lo, hi in zip(b, b[1:]))
    assert p.stage_rows % 4 == 0 and p.stage_rows > 0
    assert p.ksplit in (1, 2, 4, 8)
    if p.stages == 1:
        assert p.stage_rows >= widest  # resident: the CTA keeps its slice for all its tiles
    else:
        assert p.stages == 2 and p.stage_rows < widest
    cols = p.col_bounds
    assert cols[0] == 0 and cols[-1] == H and all(lo <= hi for lo, hi in zip(cols, cols[1:]))


def test_plan_main_path_choices():
    cal, feat, lm, req, frame = (plan_of(*a) for a in MAIN)
    # B 512: 64 tiles of 8 rows on 64 clusters of 2, inside the 66 an H100
    # holds at once with one CTA an SM
    assert (cal.cs, cal.tb, cal.tiles, cal.grid, cal.stages) == (2, 8, 64, 128, 1)
    assert (feat.cs, feat.tb, feat.grid) == (2, 2, 64)
    assert req.cs == 2 and req.grid == 64 and req.x_cols == 388
    assert lm.cs == 1 and lm.ksplit == 1  # the LM's 3 KB head: one CTA a tile
    assert frame.cs == 4 and frame.grid == 4  # a single frame spreads W1 over 4 SMs
    # about 100 KB of W1 a CTA at F 387, H 128, 2 ranks, landing in 8 chunks
    widest = max(hi - lo for lo, hi in zip(cal.bounds, cal.bounds[1:]))
    assert 96 * 1024 <= widest * 128 * 4 <= 101 * 1024 and cal.ksplit == 8


@pytest.mark.parametrize("B", [1, 64, 512, 4096])
def test_plan_grid_stays_within_the_clusters_held(B):
    """A grid past what the device holds at once runs part of itself in a
    second wave; the plan follows the capacity it is given."""
    for clusters in (None, ((1, 100), (2, 20), (4, 7), (8, 3))):
        p = mlp_plan(B, F_DET, 128, clusters=clusters)
        held = dict(clusters or H100_CLUSTERS)[p.cs]
        assert p.grid // p.cs <= held
        assert p.tiles <= held or p.tb == TILE_ROWS[-1]


def emulate_head(x, w1, b1, w2, b2, plan):
    """The kernel's summation order in plain float32 torch."""
    b = plan.bounds
    pre = None
    for lo, hi in zip(b, b[1:]):  # rank r's partials, met in rank order
        chunk = 4 * -(-(-(-(hi - lo) // plan.ksplit)) // 4)  # a multiple of 4 rows
        part = None
        for a in range(lo, hi, chunk):  # the slice's F-chunks, in chunk order
            p = x[:, a:min(hi, a + chunk)] @ w1[a:min(hi, a + chunk)]
            part = p if part is None else part + p
        pre = part if pre is None else pre + part
    hidden = Fn.gelu(pre + b1, approximate="tanh") * w2
    c = plan.col_bounds
    total = None
    for lo, hi in zip(c, c[1:]):  # rank r's share of the hidden units
        s = hidden[:, lo:hi].sum(1)
        total = s if total is None else total + s
    return torch.sigmoid(total + b2)


@pytest.mark.parametrize("B,F,H", [(512, F_DET, 128), (64, F_DET, 128), (8, 12, 64),
                                   (1, F_DET, 128), (9, 33, 17), (37, 203, 65), (5, 700, 300)])
def test_emulated_order_matches_estimator_references(B, F, H):
    rng = np.random.default_rng(B * F + H)
    x = rng.normal(0, 1, (B, F)).astype(np.float32)
    w1, b1, w2, b2 = mlp_arrays(rng, F, H)
    t = [torch.tensor(v) for v in (x, w1, b1, w2, b2)]
    got = emulate_head(*t, mlp_plan(B, F, H))
    torch.testing.assert_close(got, estimator_mlp_ref(*t), atol=1e-5, rtol=0)
    want = np.asarray(j_mlp(*(jnp.asarray(v) for v in (x, w1, b1, w2, b2)), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("B,kmax,ties,frac_empty", [(64, 64, None, 0.1), (1, 40, None, 0.0),
                                                     (33, 12, 2, 0.3), (6, 30, 4, 1.0)])
def test_emulated_order_matches_score_references(B, kmax, ties, frac_empty):
    rng = np.random.default_rng(B + kmax)
    arrays = random_detection_arrays(rng, B, kmax, NUM_CLASSES, frac_empty, ties)
    jd, td = both_detections(arrays)
    w1, b1, w2, b2 = mlp_arrays(rng, F_DET, 128)
    mu = rng.normal(0, 0.1, F_DET).astype(np.float32)
    sigma = rng.uniform(0.5, 2.0, F_DET).astype(np.float32)
    p = dict(w1=w1, b1=b1, w2=w2, b2=b2, mu=mu, sigma=sigma)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    tb = TBatch.from_list(td, device="cpu")
    # the kernel's feature rows are the plain version's: only the head's
    # order differs
    arrays_t = pad_box_axis(tb.boxes, tb.scores, tb.classes, tb.mask, TOP_K)
    x = (box_feature_stack(*arrays_t, 1.0, NUM_CLASSES, TOP_K) - tp["mu"]) / tp["sigma"]
    K = tb.boxes.shape[1]
    plan = mlp_plan(B, F_DET, 128, full_rows=True, **pipeline_scratch(K, TOP_K, F_DET))
    got = emulate_head(x, tp["w1"], tp["b1"], tp["w2"], tp["b2"], plan)
    want_t = score_pipeline_ref(tb.boxes, tb.scores, tb.classes, tb.mask, *tp.values(), 1.0,
                                NUM_CLASSES, TOP_K)
    torch.testing.assert_close(got, want_t, atol=2e-6, rtol=0)
    want_j = np.asarray(j_score(JBatch.from_list(jd), {k: jnp.asarray(v) for k, v in p.items()},
                                num_classes=NUM_CLASSES, top_k=TOP_K, image_size=1.0, path="lax"))
    np.testing.assert_allclose(got.numpy(), want_j, atol=2e-6, rtol=0)


# (B, F, H, full_rows, shards): the sharded plane's launches (the card's plane
# check at F 387 H 128, the city at F 12 H 32, score_pipeline's blocks), then
# corners
SHARDED = [(7, F_DET, 128, False, 4), (64, F_DET, 128, False, 4), (250, F_DET, 128, False, 4),
           (2000, F_DET, 128, False, 4), (1024, 12, 32, False, 4), (13, F_DET, 128, True, 4),
           (250, F_DET, 128, True, 4), (4096, 700, 300, False, 3), (5, 33, 17, False, 2)]
SUMMATION_FIELDS = ("F", "H", "cs", "bounds", "tb", "ksplit", "slab_rows", "stage_rows",
                    "stages", "x_cols", "smem")


@pytest.mark.parametrize("B,F,H,full_rows,n", SHARDED)
def test_shard_plan_keeps_the_global_summation(B, F, H, full_rows, n):
    """A shard's plan keeps every field that orders a row's sums (cluster
    size, F-split, tile, F-chunks, W1 staging) and the shared memory they
    lay out; only its rows, tiles and grid are the shard's."""
    g = plan_of(B, F, H, full_rows)
    per = -(-B // n)
    for rows in sorted({per, max(1, B - (n - 1) * per), 1}):
        p = shard_plan(g, rows)
        assert {f: getattr(p, f) for f in SUMMATION_FIELDS} == \
            {f: getattr(g, f) for f in SUMMATION_FIELDS}
        assert p.B == rows and p.tiles == -(-rows // g.tb)
        assert p.grid % p.cs == 0 and p.cs <= p.grid <= g.grid
        assert p.grid // p.cs <= p.tiles  # no cluster without a tile
    with pytest.raises(ValueError):
        shard_plan(g, 0)


def test_shard_plan_differs_from_a_shard_planned_alone():
    """Why the plane passes the global plan: at the deployable head a batch
    of 64 runs clusters of 2, while a shard of 16 planned for itself would
    run clusters of 4, splitting F (and so ordering each row's sums)
    differently."""
    g, own = plan_of(64, F_DET, 128, False), plan_of(16, F_DET, 128, False)
    assert (g.cs, own.cs) == (2, 4) and g.bounds != own.bounds
    assert shard_plan(g, 16).cs == 2 and shard_plan(g, 16).bounds == g.bounds
    # the small heads keep one CTA a cluster, but the tile and F-chunks move
    small_g, small_own = plan_of(1024, 12, 32, False), plan_of(256, 12, 32, False)
    assert small_g.cs == small_own.cs == 1
    assert (small_g.tb, small_g.ksplit) != (small_own.tb, small_own.ksplit)


def test_wrappers_check_the_plan_on_the_cpu():
    """``plan=`` must be a plan of the head; on the CPU the plain version
    runs and the plan changes nothing."""
    rng = np.random.default_rng(0)
    w = [torch.tensor(v) for v in mlp_arrays(rng, 33, 17)]
    x = torch.tensor(rng.normal(0, 1, (9, 33)).astype(np.float32))
    ref = estimator_mlp(x, *w)
    assert torch.equal(estimator_mlp(x, *w, plan=mlp_plan(40, 33, 17)), ref)
    with pytest.raises(ValueError, match="F=34"):
        estimator_mlp(x, *w, plan=mlp_plan(9, 34, 17))
    with pytest.raises(TypeError):
        estimator_mlp(x, *w, plan=(9, 33, 17))
    arrays = random_detection_arrays(rng, 5, 30, NUM_CLASSES)
    tb = TBatch.from_list(both_detections(arrays)[1], device="cpu")
    params = {k: torch.tensor(v) for k, v in zip(("w1", "b1", "w2", "b2"),
                                                  mlp_arrays(rng, F_DET, 128))}
    params.update(mu=torch.zeros(F_DET), sigma=torch.ones(F_DET))
    kw = dict(num_classes=NUM_CLASSES, top_k=TOP_K)
    full = plan_of(20, F_DET, 128, True)
    assert torch.equal(score_pipeline(tb, params, **kw, plan=full), score_pipeline(tb, params, **kw))
    with pytest.raises(ValueError, match="x_cols"):
        score_pipeline(tb, params, **kw, plan=plan_of(20, F_DET, 128, False))


@pytest.mark.parametrize("K_less,top_k_less", [(True, False), (False, True)])
def test_score_pipeline_refuses_a_plan_too_small_for_its_block(K_less, top_k_less):
    """A ``score_pipeline`` plan sizes its shared memory from K and top_k
    (``pipeline_scratch``): a plan built for a smaller K or top_k passes
    the head's checks but would launch with too little, so the wrapper
    raises, on the CPU too."""
    rng = np.random.default_rng(1)
    arrays = random_detection_arrays(rng, 5, 30, NUM_CLASSES)
    tb = TBatch.from_list(both_detections(arrays)[1], device="cpu")
    K = tb.boxes.shape[1]
    params = {k: torch.tensor(v) for k, v in zip(("w1", "b1", "w2", "b2"),
                                                  mlp_arrays(rng, F_DET, 128))}
    params.update(mu=torch.zeros(F_DET), sigma=torch.ones(F_DET))
    kw = dict(num_classes=NUM_CLASSES, top_k=TOP_K)
    fits = mlp_plan(20, F_DET, 128, full_rows=True, **pipeline_scratch(K, TOP_K, F_DET))
    assert torch.equal(score_pipeline(tb, params, **kw, plan=fits), score_pipeline(tb, params, **kw))
    small = mlp_plan(20, F_DET, 128, full_rows=True,
                     **pipeline_scratch(K // 4 if K_less else K,
                                        TOP_K - 20 if top_k_less else TOP_K, F_DET))
    assert small.x_cols == fits.x_cols and small.smem < fits.smem
    with pytest.raises(ValueError, match="shared memory"):
        score_pipeline(tb, params, **kw, plan=small)
