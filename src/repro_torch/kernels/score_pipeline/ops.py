"""Wrapper for the fused score-pipeline kernel
(``kernels/csrc/score_pipeline.cu``), which replaces
``repro/kernels/score_pipeline/kernel.py:92`` (``score_pipeline_pallas``)
and the top-k gather its wrapper ran outside it.

One launch takes a padded detection block to reward estimates: the stable
confidence top-k, the feature row, the standardize step and the MLP head all
run inside the kernel, with no intermediate in device memory; the head is
the reward head of ``kernels/csrc/mlp.cuh``, launched by ``mlp_plan`` with
whole feature rows.  A CUDA block launches the kernel, a CPU block takes
``score_pipeline_ref``.  Launches are counted in ``score_pipeline.launches``,
and by block shape (``"B=.. K=.."``) in ``score_pipeline.launches_by_shape``.
As with ``estimator_mlp``, a shard of a batch launched with the whole
batch's plan (``plan=``, from :func:`pipeline_plan`) gives each image's
estimate bit for bit as the whole batch's launch does.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core.features import feature_dim
from repro_torch.detection.batch import DetectionsBatch
from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import refuse_grad, resolve_path
from repro_torch.kernels.estimator_mlp.ops import (
    PLANS, MlpPlan, check_aligned, check_mlp_params, check_plan, device_clusters, keep_plan,
    mlp_plan, shard_plan,
)
from repro_torch.kernels.score_pipeline.ref import score_pipeline_ref

__all__ = ["pipeline_params", "pipeline_plan", "pipeline_scratch", "score_pipeline"]

_LIB = "score_pipeline"
_ARGTYPES = (
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 5
    + [ctypes.c_void_p]
)


def pipeline_params(model) -> Dict[str, torch.Tensor]:
    """The param bundle ``score_pipeline`` consumes, from a *fused*
    ``MLPRewardModel`` (one hidden layer + sigmoid head), on the model's
    device.  This is the uncached builder; ``MLPRewardModel.pipeline_params``
    caches it by the identity of the source arrays."""
    if not getattr(model, "fused", False):
        raise ValueError(
            "score_pipeline needs a fused reward model (single hidden "
            "layer + sigmoid head); score through the composed path instead"
        )
    est = model.estimator
    p = est.params
    w1 = p["layer0"]["w"].contiguous()
    dev = w1.device
    if model.config.standardize:
        mu = torch.as_tensor(est._mu, dtype=torch.float32).to(dev)
        sigma = torch.as_tensor(est._sigma, dtype=torch.float32).to(dev)
    else:
        # (x - 0) / 1 is exact in IEEE float32
        mu = torch.zeros((w1.shape[0],), dtype=torch.float32, device=dev)
        sigma = torch.ones((w1.shape[0],), dtype=torch.float32, device=dev)
    return {
        "w1": w1,
        "b1": p["layer0"]["b"].contiguous(),
        "w2": p["layer1"]["w"][:, 0].contiguous(),
        "b2": p["layer1"]["b"][0].contiguous(),
        "mu": mu,
        "sigma": sigma,
    }


def pipeline_scratch(K: int, top_k: int, F: int) -> Dict[str, int]:
    """The kernel's scratch beside the head (``sp_extra`` in
    ``score_pipeline.cu``): mu and sigma, and per image of a tile its keys
    (K rounded up to 4 floats), its detections (scores, boxes, classes: 6 K
    floats; mask: K bytes) and its top-k order."""
    ldx = (F + 3) & ~3
    return {"extra_bytes": 8 * ldx, "row_bytes": 4 * ((K + 3) & ~3) + 25 * K + 4 * top_k}


def pipeline_plan(B: int, K: int, top_k: int, F: int, H: int, device: torch.device) -> MlpPlan:
    """The plan ``score_pipeline`` launches for a (B, K) block and an (F, H)
    head on the CUDA ``device`` (kept in ``PLANS``)."""
    key = (B, K, int(top_k), F, H, device)
    return PLANS.get(key) or keep_plan(key, mlp_plan(
        B, F, H, full_rows=True, clusters=device_clusters(device),
        **pipeline_scratch(K, int(top_k), F)))


def _check_block(boxes, scores, classes, mask) -> Tuple[int, int]:
    if boxes.ndim != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, K, 4), got {tuple(boxes.shape)}")
    B, K = boxes.shape[:2]
    for name, t, dtype in (
        ("boxes", boxes, torch.float32),
        ("scores", scores, torch.float32),
        ("classes", classes, torch.int32),
        ("mask", mask, torch.bool),
    ):
        if name != "boxes" and tuple(t.shape) != (B, K):
            raise ValueError(f"{name} must be ({B}, {K}), got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != boxes.device:
            raise ValueError(f"{name} is on {t.device}, boxes on {boxes.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return B, K


def score_pipeline(
    batch: Union[DetectionsBatch, Tuple],
    params: Dict[str, torch.Tensor],
    *,
    num_classes: int,
    top_k: int = 25,
    image_size: float = 1.0,
    plan: Optional[MlpPlan] = None,
) -> torch.Tensor:
    """(B,) float32 reward estimates for a padded detection block, on the
    block's device.

    ``batch`` is a :class:`DetectionsBatch` or a ``(boxes, scores, classes,
    mask)`` tuple of tensors; ``params`` comes from :func:`pipeline_params`
    and must lie on the same device.  Callers leave the device once, at the
    policy boundary.  ``plan``: a whole batch's plan (:func:`pipeline_plan`,
    same K and top_k; a plan whose shared memory is too small for this
    block's scratch raises) when the block is a shard of that batch; the
    kernel launches it cut to the shard's images, counted under ``"B=..
    K=.. of=<the whole batch's B>"``.
    """
    if isinstance(batch, DetectionsBatch):
        arrays = (batch.boxes, batch.scores, batch.classes, batch.mask)
    else:
        arrays = tuple(batch)
    boxes, scores, classes, mask = arrays
    B, K = _check_block(boxes, scores, classes, mask)
    p = params
    F, H = check_mlp_params(boxes.device, p["w1"], p["b1"], p["w2"], p["b2"])
    expect = feature_dim(int(num_classes), int(top_k))
    if F != expect:
        raise ValueError(
            f"reward model expects {F} features but the detection extractor "
            f"produces {expect} (num_classes={num_classes}, top_k={top_k})"
        )
    for name in ("mu", "sigma"):
        t = p[name]
        if tuple(t.shape) != (F,) or t.dtype != torch.float32 or t.device != boxes.device:
            raise ValueError(f"{name} must be float32 ({F},) on {boxes.device}")
    if plan is not None:
        check_plan(plan, F, H, x_cols=(F + 3) & ~3, **pipeline_scratch(K, int(top_k), F))
    refuse_grad("score_pipeline", boxes, scores,
                *(p[k] for k in ("w1", "b1", "w2", "b2", "mu", "sigma")))
    if B == 0:  # a zero-sized grid is refused by CUDA
        return torch.zeros((0,), dtype=torch.float32, device=boxes.device)
    if resolve_path(boxes) == "reference":
        return score_pipeline_ref(
            boxes, scores, classes, mask,
            p["w1"], p["b1"], p["w2"], p["b2"], p["mu"], p["sigma"],
            float(image_size), int(num_classes), int(top_k),
        )
    check_aligned(w1=p["w1"])
    whole = None if plan is None else plan.B
    plan = (pipeline_plan(B, K, int(top_k), F, H, boxes.device) if plan is None
            else shard_plan(plan, B))
    out = torch.empty((B,), dtype=torch.float32, device=boxes.device)
    fn = _build.function(_LIB, "score_pipeline_f32", _ARGTYPES, boxes.device)
    with torch.cuda.device(boxes.device):
        rc = fn(
            boxes.data_ptr(), scores.data_ptr(), classes.data_ptr(), mask.data_ptr(),
            p["w1"].data_ptr(), p["b1"].data_ptr(), p["w2"].data_ptr(),
            p["b2"].data_ptr(), p["mu"].data_ptr(), p["sigma"].data_ptr(),
            out.data_ptr(), B, K, int(top_k), int(num_classes), F, H,
            float(image_size), plan.cs, plan.tb, plan.grid, plan.slab_rows, plan.smem,
            _build.stream_ptr(boxes.device),
        )
    _build.check(rc, _LIB, "score_pipeline")
    score_pipeline.launches += 1
    key = f"B={B} K={K}" + (f" of={whole}" if whole is not None else "")
    score_pipeline.launches_by_shape[key] = score_pipeline.launches_by_shape.get(key, 0) + 1
    return out


score_pipeline.launches = 0
score_pipeline.launches_by_shape = {}
