"""Wrappers for the iou_matrix kernel family: three routes that share the IoU
arithmetic and the stable rank on the device (``kernels/csrc/iou.cuh``).

=========  ======================================  ==============================
route      computes                                source
=========  ======================================  ==============================
``matrix`` ``out[b, k, m] = iou(a[b, k], g[b, m])`` ``csrc/iou_matrix.cu``
``nms``    greedy class-aware NMS keep mask         ``csrc/iou_nms.cu``
``match``  COCO greedy matching (tp, match_gt)      ``csrc/iou_match.cu``
=========  ======================================  ==============================

``iou_matrix_batch`` replaces ``repro/kernels/iou_matrix/kernel.py:64``
(``iou_matrix_batch_pallas``) and ``iou_matrix`` replaces ``kernel.py:90``
(``iou_matrix_pallas``), the B = 1 launch of the same kernel.  ``nms_keep``
and ``greedy_match`` consume the IoU tile in the launch that builds it, for
``detection/nms.py`` and ``detection/batch.py``.

A CUDA tensor launches the kernel (or raises: a size past a route's limit, a
build or launch failure), a CPU tensor takes the plain version in ``ref.py``.
A launch of any route over one image counts in ``iou_matrix.launches``, over
more in ``iou_matrix_batch.launches``; each also counts in the wrapper's
``launches_by_route`` and, by route and shape (``"matrix B=8 K=16 M=16"``),
in its ``launches_by_shape``.  :func:`iou_plan` is the one owner of each route's
shared-memory layout; the kernels take its offsets.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import refuse_grad, resolve_path
from repro_torch.kernels.iou_matrix.ref import (
    greedy_match_ref,
    iou_matrix_batch_ref,
    iou_matrix_ref,
    nms_keep_ref,
)

__all__ = ["IouPlan", "ROUTES", "SOURCES", "greedy_match", "iou_matrix", "iou_matrix_batch",
           "iou_plan", "nms_keep"]

ROUTES = ("matrix", "nms", "match")
# each route's source, csrc/<name>.cu (a library each)
SOURCES = {"matrix": "iou_matrix", "nms": "iou_nms", "match": "iou_match"}
THREADS = 256  # IOU_THREADS
SMEM_LIMIT = 232448  # the shared memory an H100 block may use
# a route's limits: matrix columns (g boxes staged whole), NMS boxes an image
# (the suppression words are N^2 / 8 bytes), matching's detections, GT slots
# (a lane's taken bits fit one 32-bit register) and thresholds
LIMITS = {
    "matrix": {"M": 8192},
    "nms": {"N": 1024},
    "match": {"K": 2048, "M": 1024, "T": 64},
}
# shared-memory arrays of each route, in the order of its enum in the source
MATRIX_FIELDS = ("g", "a")
NMS_FIELDS = ("boxes", "sup", "keys", "order", "rank", "classes", "keep")
MATCH_FIELDS = ("det_boxes", "gt_boxes", "keys", "order", "det_classes", "gt_classes", "taken",
                "tile", "det_mask", "gt_mask")
MAX_OFFSETS = 12  # IOU_OFFSETS


class _PlanC(ctypes.Structure):
    """``IouPlan`` in ``csrc/iou.cuh``, field for field."""

    _fields_ = [("smem", ctypes.c_int), ("rows", ctypes.c_int), ("words", ctypes.c_int),
                ("lanes", ctypes.c_int), ("off", ctypes.c_int * MAX_OFFSETS)]


@dataclass(frozen=True)
class IouPlan:
    """A route's launch plan for one image (``iou_plan``): ``smem`` bytes of
    dynamic shared memory a CTA, laid out as ``offsets`` (field, byte offset);
    ``rows`` a CTA (matrix) or IoU tile rows a chunk (match); ``words``
    64-bit suppression words a row (nms); ``lanes`` a slot's rank is counted
    by; ``grid_rows`` CTAs an image (matrix; 1 otherwise); ``limits`` the
    route's."""

    route: str
    smem: int
    rows: int
    words: int
    lanes: int
    grid_rows: int
    offsets: Tuple[Tuple[str, int], ...]
    limits: Tuple[Tuple[str, int], ...]

    def c_struct(self) -> _PlanC:
        c = _PlanC(self.smem, self.rows, self.words, self.lanes)
        for i, (_, off) in enumerate(self.offsets):
            c.off[i] = off
        return c


def _pad(n: int, to: int) -> int:
    return -(-n // to) * to


def _layout(fields: Tuple[str, ...], sizes: Dict[str, int]):
    """(field, byte offset) of each of ``fields`` in order, each 16-byte
    aligned, and the total bytes."""
    offsets, at = [], 0
    for name in fields:
        offsets.append((name, at))
        at += _pad(sizes[name], 16)
    return tuple(offsets), at


def _rank_lanes(n: int) -> int:
    """Lanes that count one slot's rank: the largest power of 2 <= 8 with n
    slots' lanes within the CTA (``block_rank``)."""
    lanes = 1
    while lanes < 8 and n * lanes * 2 <= THREADS:
        lanes *= 2
    return lanes


def _refuse(route: str, name: str, value: int) -> None:
    top = LIMITS[route][name]
    if value > top:
        raise ValueError(f"the {route} route takes {name} <= {top} an image, got {name}={value}")


def iou_plan(route: str, K: int, M: int = 0, T: int = 0) -> IouPlan:
    """The launch plan of ``route`` for one image.  Pure Python, so the CPU
    tests check it.  ``matrix``: K rows of a against M columns of g; ``nms``:
    K boxes (M, T unused); ``match``: K detections, M GT slots, T thresholds.
    Raises ``ValueError`` past the route's ``LIMITS`` or shared memory."""
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}; use one of {ROUTES}")
    limits = tuple(LIMITS[route].items())
    if route == "matrix":
        if min(K, M) < 1:
            raise ValueError(f"the matrix route needs K, M >= 1, got {(K, M)}")
        _refuse(route, "M", M)
        # about one group of 4 outputs (one output where M % 4 != 0) a thread
        per_row = M // 4 if M % 4 == 0 else M
        rows = min(K, max(1, THREADS // per_row))
        grid_rows = -(-K // rows)
        if grid_rows > 65535:
            raise ValueError(f"the matrix route takes K <= {65535 * rows} at M={M}, got K={K}")
        offsets, smem = _layout(MATRIX_FIELDS, dict(g=16 * M, a=16 * rows))
        return IouPlan(route, smem, rows, 0, 0, grid_rows, offsets, limits)
    if route == "nms":
        if K < 1:
            raise ValueError(f"the nms route needs N >= 1, got {K}")
        _refuse(route, "N", K)
        words = -(-K // 64)
        offsets, smem = _layout(NMS_FIELDS, dict(
            boxes=16 * K, sup=8 * K * words, keys=4 * _pad(K, 4), order=4 * K, rank=4 * K,
            classes=4 * K, keep=8 * words))
        return IouPlan(route, smem, 0, words, _rank_lanes(K), 1, offsets, limits)
    if min(K, M, T) < 1:
        raise ValueError(f"the match route needs K, M, T >= 1, got {(K, M, T)}")
    for name, value in (("K", K), ("M", M), ("T", T)):
        _refuse(route, name, value)
    sizes = dict(det_boxes=16 * K, gt_boxes=16 * M, keys=4 * _pad(K, 4), order=4 * K,
                 det_classes=4 * K, gt_classes=4 * M, taken=4 * 32 * T, tile=0, det_mask=K,
                 gt_mask=M)
    _, fixed = _layout(MATCH_FIELDS, sizes)
    rows = min(K, (SMEM_LIMIT - fixed) // (4 * M))  # all K where they fit
    if rows < 1:
        raise ValueError(f"no IoU tile row of M={M} fits beside the match route's arrays")
    offsets, smem = _layout(MATCH_FIELDS, {**sizes, "tile": 4 * rows * M})
    return IouPlan(route, smem, rows, 0, _rank_lanes(K), 1, offsets, limits)


# each route's plan by (route, K, M, T), with its C structure and the
# structure's address, so that a call finds them with one dict lookup
PLANS: Dict[tuple, Tuple[IouPlan, _PlanC, int]] = {}


def _plan(route: str, K: int, M: int = 0, T: int = 0) -> Tuple[IouPlan, _PlanC, int]:
    key = (route, K, M, T)
    got = PLANS.get(key)
    if got is None:
        plan = iou_plan(route, K, M, T)
        if len(PLANS) >= 4096:
            PLANS.clear()
        c = plan.c_struct()
        got = PLANS[key] = (plan, c, ctypes.addressof(c))
    return got


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ENTRIES = {
    ("matrix", torch.float32): ("iou_matrix_f32", [_P] * 3 + [_I] * 3 + [_P, _P]),
    ("matrix", torch.bfloat16): ("iou_matrix_bf16", [_P] * 3 + [_I] * 3 + [_P, _P]),
    ("nms", torch.float32): ("iou_nms_f32", [_P] * 4 + [_I] * 2 + [_F] * 2 + [_P, _P]),
    ("match", torch.float32): ("iou_match_f32", [_P] * 10 + [_I] * 4 + [_P, _P]),
}


def _launch(route: str, dtype: torch.dtype, device: torch.device, *args) -> None:
    """Calls the route's C entry with ``args`` and the current stream on
    ``device``; raises on a CUDA error."""
    name, argtypes = _ENTRIES[(route, dtype)]
    fn = _build.function(SOURCES[route], name, argtypes, device)
    if device.index is None or device.index == torch.cuda.current_device():
        rc = fn(*args, _build.stream_ptr(device))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, _build.stream_ptr(device))
    _build.check(rc, SOURCES[route], f"iou_matrix ({route} route)")


def _count(B: int, route: str, shape: str) -> None:
    wrapper = iou_matrix if B == 1 else iou_matrix_batch
    wrapper.launches += 1
    wrapper.launches_by_route[route] += 1
    key = f"{route} {shape}"
    wrapper.launches_by_shape[key] = wrapper.launches_by_shape.get(key, 0) + 1


def _check_boxes(t: torch.Tensor, name: str, dtypes=(torch.float32,)) -> None:
    """A (B, n, 4) box tensor the kernels take: a listed dtype, contiguous,
    each box in one aligned load."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % (4 * t.element_size()):
        raise ValueError(f"{name} must start aligned to one box ({4 * t.element_size()} bytes); "
                         f"got a view at offset {t.data_ptr() % 16} mod 16")


def _check_same(device: torch.device, **tensors) -> None:
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, boxes on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_pair(a: torch.Tensor, b: torch.Tensor, ndim: int) -> None:
    if a.ndim != ndim or b.ndim != ndim or a.shape[-1] != 4 or b.shape[-1] != 4:
        raise ValueError(
            f"expected boxes of rank {ndim} with 4 coordinates, got "
            f"{tuple(a.shape)} and {tuple(b.shape)}"
        )
    if ndim == 3 and a.shape[0] != b.shape[0]:
        raise ValueError(f"batch size mismatch: {a.shape[0]} vs {b.shape[0]}")
    if a.device != b.device:
        raise ValueError(f"boxes on different devices: {a.device} vs {b.device}")
    if a.dtype != b.dtype or a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"boxes must both be float32 or bfloat16, got {a.dtype}, {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("boxes must be contiguous")


def _matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, K, 4) x (B, M, 4) -> (B, K, M) on the card; every size >= 1."""
    B, K, M = a.shape[0], a.shape[1], b.shape[1]
    _, _, plan_at = _plan("matrix", K, M)
    for t, name in ((a, "a"), (b, "b")):
        _check_boxes(t, name, (torch.float32, torch.bfloat16))
    out = torch.empty((B, K, M), dtype=a.dtype, device=a.device)
    _launch("matrix", a.dtype, a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(), B, K, M, plan_at)
    _count(B, "matrix", f"B={B} K={K} M={M}")
    return out


def iou_matrix_batch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-image pairwise IoU, image i matched only against its own row:
    ``out[i] = iou(a[i], b[i])`` with shape (B, K, M)."""
    _check_pair(a, b, 3)
    refuse_grad("iou_matrix_batch", a, b)
    if resolve_path(a) == "reference":
        return iou_matrix_batch_ref(a, b)
    if a.numel() == 0 or b.numel() == 0:
        return torch.zeros((a.shape[0], a.shape[1], b.shape[1]), dtype=a.dtype, device=a.device)
    return _matrix(a, b)


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU ``(N, 4) x (M, 4) -> (N, M)``."""
    _check_pair(a, b, 2)
    refuse_grad("iou_matrix", a, b)
    if resolve_path(a) == "reference":
        return iou_matrix_ref(a, b)
    if a.numel() == 0 or b.numel() == 0:
        return torch.zeros((a.shape[0], b.shape[0]), dtype=a.dtype, device=a.device)
    return _matrix(a[None], b[None])[0]


def nms_keep(
    boxes: torch.Tensor,  # (B, N, 4) float32
    scores: torch.Tensor,  # (B, N) float32
    classes: torch.Tensor,  # (B, N) int32
    iou_threshold: float = 0.5,
    score_threshold: float = 0.0,
) -> torch.Tensor:
    """Keep mask ``(B, N)`` of class-aware greedy NMS on every image, in
    slot order (``nms_keep_ref``).  The thresholds are compared in float32,
    as the plain version compares them; on the card it is one launch of the
    ``nms`` route, N at most ``LIMITS["nms"]["N"]``."""
    if boxes.ndim != 3 or boxes.shape[-1] != 4 or scores.shape != boxes.shape[:2] \
            or classes.shape != scores.shape:
        raise ValueError(f"expected boxes (B, N, 4), scores and classes (B, N), got "
                         f"{tuple(boxes.shape)}, {tuple(scores.shape)}, {tuple(classes.shape)}")
    if resolve_path(boxes) == "reference":
        return nms_keep_ref(boxes, scores, classes, iou_threshold, score_threshold)
    B, N = scores.shape
    if B == 0 or N == 0:
        return torch.zeros((B, N), dtype=torch.bool, device=boxes.device)
    _, _, plan_at = _plan("nms", N)
    _check_boxes(boxes, "boxes")
    _check_same(boxes.device, scores=scores, classes=classes)
    if scores.dtype != torch.float32 or classes.dtype != torch.int32:
        raise TypeError(f"scores must be float32 and classes int32, got {scores.dtype}, "
                        f"{classes.dtype}")
    keep = torch.empty((B, N), dtype=torch.bool, device=boxes.device)
    _launch("nms", torch.float32, boxes.device, boxes.data_ptr(), scores.data_ptr(),
            classes.data_ptr(), keep.data_ptr(), B, N, iou_threshold, score_threshold, plan_at)
    _count(B, "nms", f"B={B} N={N}")
    return keep


_MATCH_TYPES = (("det_scores", torch.float32), ("det_classes", torch.int32),
                ("det_mask", torch.bool), ("gt_classes", torch.int32), ("gt_mask", torch.bool),
                ("thresholds", torch.float32))


def greedy_match(
    det_boxes: torch.Tensor,  # (B, K, 4) float32
    det_scores: torch.Tensor,  # (B, K) float32
    det_classes: torch.Tensor,  # (B, K) int32
    det_mask: torch.Tensor,  # (B, K) bool
    gt_boxes: torch.Tensor,  # (B, M, 4) float32
    gt_classes: torch.Tensor,  # (B, M) int32
    gt_mask: torch.Tensor,  # (B, M) bool
    thresholds: torch.Tensor,  # (T,) float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """COCO greedy matching (``greedy_match_ref``): ``tp (B, T, K)`` bool and
    ``match_gt (B, T, K)`` int32 (-1 on a miss) at the detections' slots.  On
    the card it is one launch of the ``match`` route (none where K, M or T is
    0), within ``LIMITS["match"]``."""
    B, K = det_scores.shape
    M, T = gt_boxes.shape[1], thresholds.shape[0]
    if det_boxes.shape != (B, K, 4) or gt_boxes.shape != (B, M, 4) or thresholds.ndim != 1:
        raise ValueError(f"expected det boxes (B, K, 4), gt boxes (B, M, 4), thresholds (T,), got "
                         f"{tuple(det_boxes.shape)}, {tuple(gt_boxes.shape)}, "
                         f"{tuple(thresholds.shape)}")
    if resolve_path(det_boxes) == "reference":
        return greedy_match_ref(det_boxes, det_scores, det_classes, det_mask, gt_boxes,
                                gt_classes, gt_mask, thresholds)
    dev = det_boxes.device
    if min(B, K, M, T) == 0:
        return (torch.zeros((B, T, K), dtype=torch.bool, device=dev),
                torch.full((B, T, K), -1, dtype=torch.int32, device=dev))
    _, _, plan_at = _plan("match", K, M, T)
    tensors = dict(det_scores=det_scores, det_classes=det_classes, det_mask=det_mask,
                   gt_classes=gt_classes, gt_mask=gt_mask, thresholds=thresholds)
    _check_boxes(det_boxes, "det_boxes")
    _check_boxes(gt_boxes, "gt_boxes")
    _check_same(dev, gt_boxes=gt_boxes, **tensors)
    for name, dtype in _MATCH_TYPES:
        if tensors[name].dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {tensors[name].dtype}")
    tp = torch.empty((B, T, K), dtype=torch.bool, device=dev)
    match_gt = torch.empty((B, T, K), dtype=torch.int32, device=dev)
    _launch("match", torch.float32, dev, det_boxes.data_ptr(), det_scores.data_ptr(),
            det_classes.data_ptr(), det_mask.data_ptr(), gt_boxes.data_ptr(),
            gt_classes.data_ptr(), gt_mask.data_ptr(), thresholds.data_ptr(), tp.data_ptr(),
            match_gt.data_ptr(), B, K, M, T, plan_at)
    _count(B, "match", f"B={B} K={K} M={M} T={T}")
    return tp, match_gt


for _wrapper in (iou_matrix, iou_matrix_batch):
    _wrapper.launches = 0
    _wrapper.launches_by_route = dict.fromkeys(ROUTES, 0)
    _wrapper.launches_by_shape = {}
