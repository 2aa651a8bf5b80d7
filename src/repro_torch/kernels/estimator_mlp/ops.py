"""Wrapper for the estimator MLP kernel (``kernels/csrc/estimator_mlp.cu``),
which replaces ``repro/kernels/estimator_mlp/kernel.py:27``
(``estimator_mlp_pallas``), and :func:`mlp_plan`, the launch plan of the
reward head (``kernels/csrc/mlp.cuh``) that it and ``score_pipeline`` share.

A CUDA tensor launches the kernel, a CPU tensor takes ``estimator_mlp_ref``.
The kernel takes any F and H as they are (no padding).  Launches are counted
in ``estimator_mlp.launches``, and by input shape (``"B=.. F=.. H=.."``) in
``estimator_mlp.launches_by_shape``.

The order in which a row's float32 sums are taken follows the plan (the
cluster size, its F-split, the tile and the F-chunks), and the plan follows
B.  A caller that cuts one batch into shards and wants each row bit for bit
as the whole batch gives it (``repro_torch.fleet.FleetPlane``) passes the
whole batch's plan as ``plan=``: the wrapper launches it cut to the shard's
rows (:func:`shard_plan`).
"""
from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import refuse_grad, resolve_path
from repro_torch.kernels.estimator_mlp.ref import estimator_mlp_ref

__all__ = ["MlpPlan", "PLANS", "estimator_mlp", "check_mlp_params", "check_aligned",
           "device_clusters", "head_plan", "keep_plan", "mlp_plan", "shard_plan"]

_LIB = "estimator_mlp"
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]

# H100 SXM: SMs, the largest cluster that is portable, the shared memory a
# block may use (232,448 bytes), and the rows a tile may hold (the tile
# sizes mlp.cuh instantiates)
SMS = 132
MAX_CLUSTER = 8
SMEM_LIMIT = 232448
TILE_ROWS = (2, 4, 8, 16, 32, 64)
# clusters of 1, 2, 4 and 8 CTAs an H100 80GB HBM3 holds at once with one
# CTA an SM (cudaOccupancyMaxActiveClusters; clusters are placed within a
# GPC, so 4 x 30 and 8 x 15 fall short of 132): the plan's default, and what
# the wrappers ask the device for
H100_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15}
# mbarriers a CTA keeps (a resident slice's F-chunks, or a ring's stages)
MLP_BARS = 8
# warps of a CTA, and the hidden units a warp's register tile spans
WARPS = 8
WARP_COLS = 128
# a head whose W1 is at most this many bytes is staged whole by one CTA
SMALL_HEAD_BYTES = 32 * 1024


def _pad4(n: int) -> int:
    return (n + 3) & ~3


def _pad16(n: int) -> int:
    return (n + 15) & ~15


def slice_start(F: int, cs: int, r: int) -> int:
    """First row of F that rank ``r`` of ``cs`` owns: the ceil(F / 4) groups
    of 4 rows split evenly (``mlp_slice_start`` in ``mlp.cuh``)."""
    return min(F, 4 * ((r * ((F + 3) // 4)) // cs))


@dataclass(frozen=True)
class MlpPlan:
    """A launch of the reward head: clusters of ``cs`` CTAs over ``grid``
    CTAs, tiles of ``tb`` rows (``tiles`` of them, a cluster walking tiles
    ``c, c + grid / cs, ...``), rank r owning rows ``bounds[r]:bounds[r+1]``
    of F, W1 staged in ``stages`` buffers of ``stage_rows`` rows (1: every
    slice resident; 2: a ring of slabs), each slab cut into ``ksplit``
    F-chunks (one per warp group, summed in chunk order), ``smem`` bytes of
    dynamic shared memory a CTA."""

    B: int
    F: int
    H: int
    cs: int
    tb: int
    tiles: int
    grid: int
    bounds: Tuple[int, ...]
    slab_rows: int
    stage_rows: int
    ksplit: int
    stages: int
    x_cols: int
    smem: int

    @property
    def col_bounds(self) -> Tuple[int, ...]:
        """The hidden units each rank sums over the cluster: ``[r H / cs,
        (r + 1) H / cs)``."""
        return tuple(r * self.H // self.cs for r in range(self.cs + 1))


def _floor_pow2(n: int) -> int:
    return 1 << (max(n, 1).bit_length() - 1)


def ksplit(tb: int, H: int, slice4: int) -> int:
    """F-chunks a slab is cut into so that the 8 warps all work (8 over the
    (rows x 128 hidden units) blocks of a tile), no chunk shorter than 16
    rows of the widest slice; a power of 2 (``mlp_ksplit``)."""
    blocks = (tb // min(tb, 8)) * -(-H // WARP_COLS)
    by_warps = 1 if blocks >= WARPS else _floor_pow2(WARPS // blocks)
    return min(by_warps, _floor_pow2(slice4 // 16))


def _layout(F, H, cs, tb, slab_rows, x_cols, extra):
    """(slice4, stage_rows, stages, x_cols, bytes): ``mlp_layout`` in
    ``mlp.cuh``."""
    widest = max(slice_start(F, cs, r + 1) - slice_start(F, cs, r) for r in range(cs))
    slice4 = _pad4(widest)
    stage_rows = min(slab_rows, slice4)
    stages = 1 if slab_rows >= slice4 else 2
    x_cols = x_cols or slice4
    xs = 8 * MLP_BARS + 4 * stages * stage_rows * H
    part = xs + 4 * tb * x_cols
    b1 = _pad16(part + 4 * ksplit(tb, H, slice4) * tb * H)
    w2 = _pad16(b1 + 4 * H)
    b2 = _pad16(w2 + 4 * H)
    rowslot = b2 + 16
    return slice4, stage_rows, stages, x_cols, _pad16(rowslot + 4 * MAX_CLUSTER * tb) + extra


def mlp_plan(B: int, F: int, H: int, *, full_rows: bool = False, extra_bytes: int = 0,
             row_bytes: int = 0, clusters: Tuple[Tuple[int, int], ...] = None) -> MlpPlan:
    """The launch plan of the reward head for a (B, F) input and an (F, H)
    W1.  Pure Python, so the CPU tests check it.

    - ``cs``: 1 for a head whose W1 fits in ``SMALL_HEAD_BYTES`` (the LM's F
      12 / H 64); else 4 (a quarter of W1 a CTA, 50 KB at F 387, H 128) while
      tiles of 2 rows fit the clusters of 4 the device holds (B <= 60 on an
      H100), and 2 past that (B 64: 32 clusters of 2; B 512: 64 of 8-row
      tiles on 128 SMs): a CTA's time grows with its rows, so a batch wants
      small tiles on every SM, and the clusters of 4 the card holds cover
      only 120 SMs; raised while a slice does not fit in shared memory;
      never above the number of 4-row groups of F.
    - ``tb``: the least tile that lets every cluster take at most one tile
      while the grid stays within ``clusters`` (pairs (cs, clusters the
      device holds at once with one CTA an SM); default ``H100_CLUSTERS``):
      a grid past that runs part of itself in a second wave, or doubles CTAs
      up on SMs, and the slowest CTA sets the time.  Past 64 rows a tile,
      clusters walk several tiles and keep their W1 slice.
    - The x tile is the tile's rows of the rank's slice, or, with
      ``full_rows`` (``score_pipeline``, which builds whole feature rows),
      of all F; the caller's scratch is ``extra_bytes`` plus ``row_bytes``
      a tile row.
    - Where a slice does not fit in ``SMEM_LIMIT`` bytes, it streams through
      a 2-stage ring of the largest slabs that fit.
    """
    if min(B, F, H) < 1:
        raise ValueError(f"mlp_plan needs B, F, H >= 1, got {(B, F, H)}")
    quads = (F + 3) // 4
    capacity = dict(clusters or H100_CLUSTERS)
    if F * H * 4 <= SMALL_HEAD_BYTES:
        cs = 1
    else:
        cs = 4 if -(-B // TILE_ROWS[0]) <= capacity.get(4, SMS // 4) else 2

    def tile_for(cs):
        held = max(1, capacity.get(cs, SMS // cs))
        return next((t for t in TILE_ROWS if -(-B // t) <= held), TILE_ROWS[-1])

    def layout(cs, tb, slab_rows):
        return _layout(F, H, cs, tb, slab_rows, _pad4(F) if full_rows else 0,
                       extra_bytes + tb * row_bytes)

    def fits(cs, tb, slab_rows):
        return layout(cs, tb, slab_rows)[-1] <= SMEM_LIMIT

    while cs < MAX_CLUSTER and not fits(cs, tile_for(cs), _pad4(F)):
        cs *= 2
    cs = min(cs, _floor_pow2(quads))  # every rank owns rows
    tb = tile_for(cs)
    slab_rows = _pad4(F)  # resident: at least every slice
    if not fits(cs, tb, slab_rows):
        # the largest slab (a multiple of 4 rows) of a 2-stage ring that fits
        slab_rows = 4
        while fits(cs, tb, slab_rows + 4):
            slab_rows += 4
        while not fits(cs, tb, slab_rows) and tb > TILE_ROWS[0]:
            tb //= 2
        if not fits(cs, tb, slab_rows):
            raise ValueError(f"no launch plan of the reward head fits F={F}, H={H} in shared memory")
    tiles = -(-B // tb)
    grid = cs * min(tiles, max(1, capacity.get(cs, SMS // cs)))
    slice4, stage_rows, stages, x_cols, smem = layout(cs, tb, slab_rows)
    return MlpPlan(
        B=B, F=F, H=H, cs=cs, tb=tb, tiles=tiles, grid=grid,
        bounds=tuple(slice_start(F, cs, r) for r in range(cs + 1)),
        slab_rows=slab_rows, stage_rows=stage_rows, ksplit=ksplit(tb, H, slice4), stages=stages,
        x_cols=x_cols, smem=smem,
    )


def shard_plan(plan: MlpPlan, rows: int) -> MlpPlan:
    """``plan``, a whole batch's, cut to a shard of ``rows`` of its rows: the
    same cluster size, F-split, tile, W1 staging and F-chunks (so a row's
    sums are taken in the same order as in the whole batch's launch); only
    the tiles and the grid shrink to the shard's."""
    if rows < 1:
        raise ValueError(f"a shard needs at least one row, got {rows}")
    tiles = -(-rows // plan.tb)
    return dataclasses.replace(plan, B=rows, tiles=tiles,
                               grid=plan.cs * min(tiles, plan.grid // plan.cs))


def check_plan(plan: MlpPlan, F: int, H: int, x_cols: int = 0, extra_bytes: int = 0,
               row_bytes: int = 0) -> None:
    """Raise unless ``plan`` is a plan of an (F, H) head (with ``x_cols``
    columns of x a tile row, when given) whose shared memory holds the
    caller's scratch of ``extra_bytes`` plus ``row_bytes`` a tile row."""
    if not isinstance(plan, MlpPlan):
        raise TypeError(f"plan must be an MlpPlan, got {type(plan).__name__}")
    if (plan.F, plan.H) != (F, H) or (x_cols and plan.x_cols != x_cols):
        raise ValueError(f"plan is for F={plan.F}, H={plan.H} (x_cols {plan.x_cols}); "
                         f"the head is F={F}, H={H}" + (f" (x_cols {x_cols})" if x_cols else ""))
    need = _layout(F, H, plan.cs, plan.tb, plan.slab_rows, plan.x_cols,
                   extra_bytes + plan.tb * row_bytes)[-1]
    if plan.smem < need:
        raise ValueError(f"plan has {plan.smem} bytes of shared memory a CTA; "
                         f"its layout with this scratch needs {need}")


_CLUSTERS: Dict[int, Tuple[Tuple[int, int], ...]] = {}
# each launch's plan by the wrapper's key (its shapes and device), so that a
# call finds it with one dict lookup: on the serve paths the wrappers' host
# time is most of a call's cost
PLANS: Dict[tuple, MlpPlan] = {}


def keep_plan(key: tuple, plan: MlpPlan) -> MlpPlan:
    """``plan`` into ``PLANS`` under ``key`` (emptied past 4096 keys)."""
    if len(PLANS) >= 4096:
        PLANS.clear()
    PLANS[key] = plan
    return plan


def device_clusters(device: torch.device) -> Tuple[Tuple[int, int], ...]:
    """(cs, clusters of cs CTAs the device holds at once with one CTA an SM)
    for cs = 1, 2, 4, 8, asked of the device once (``mlp_plan``'s
    ``clusters``)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    got = _CLUSTERS.get(index)
    if got is None:
        fn = _build.function(_LIB, "estimator_mlp_max_clusters", [ctypes.c_int] * 2, device)
        with torch.cuda.device(device):
            got = tuple((cs, max(1, fn(cs, SMEM_LIMIT))) for cs in (1, 2, 4, 8))
        _CLUSTERS[index] = got
    return got


def head_plan(B: int, F: int, H: int, device: torch.device) -> MlpPlan:
    """The plan ``estimator_mlp`` launches for a (B, F) input and an (F, H)
    W1 on the CUDA ``device`` (kept in ``PLANS``)."""
    key = (B, F, H, device)
    return PLANS.get(key) or keep_plan(key, mlp_plan(B, F, H, clusters=device_clusters(device)))


def check_aligned(**tensors) -> None:
    """Raise unless every tensor's data starts 16-byte aligned (the bulk
    copies of W1 need it; a fresh tensor always is, a view may not be)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned (a fresh tensor does; got a view "
                             f"at offset {t.data_ptr() % 16} mod 16)")


def check_mlp_params(device, w1, b1, w2, b2) -> "tuple[int, int]":
    """Validate the head's weights against ``device``; returns (F, H)."""
    if w1.ndim != 2:
        raise ValueError(f"w1 must be (F, H), got {tuple(w1.shape)}")
    F, H = w1.shape
    for name, t, shape in (("w1", w1, (F, H)), ("b1", b1, (H,)), ("w2", w2, (H,)), ("b2", b2, ())):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, inputs on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return F, H


def estimator_mlp(
    x: torch.Tensor,  # (B, F)
    w1: torch.Tensor,  # (F, H)
    b1: torch.Tensor,  # (H,)
    w2: torch.Tensor,  # (H,)
    b2: torch.Tensor,  # ()
    *,
    plan: Optional[MlpPlan] = None,
) -> torch.Tensor:
    """``sigmoid(gelu_tanh(x @ w1 + b1) @ w2 + b2)`` -> (B,) float32.

    ``plan``: a whole batch's plan (:func:`head_plan`) when ``x`` is a shard
    of that batch; the kernel then launches it cut to ``x``'s rows, so each
    row comes out bit for bit as in the whole batch's launch, and the launch
    counts under ``"B=.. F=.. H=.. of=<the whole batch's B>"``.  The plain
    version has no plan: on the CPU it is only checked against the head."""
    F, H = check_mlp_params(x.device, w1, b1, w2, b2)
    if plan is not None:
        check_plan(plan, F, H)
    if x.ndim != 2 or x.shape[1] != F:
        raise ValueError(f"x must be (B, {F}), got {tuple(x.shape)}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError(f"x must be contiguous float32, got {x.dtype}")
    refuse_grad("estimator_mlp", x, w1, b1, w2, b2)
    B = x.shape[0]
    if B == 0:  # a zero-sized grid is refused by CUDA
        return torch.zeros((0,), dtype=torch.float32, device=x.device)
    if resolve_path(x) == "reference":
        return estimator_mlp_ref(x, w1, b1, w2, b2)
    check_aligned(w1=w1)  # x arrives by 4-byte cp.async: any float32 view will do
    whole = None if plan is None else plan.B
    plan = head_plan(B, F, H, x.device) if plan is None else shard_plan(plan, B)
    out = torch.empty((B,), dtype=torch.float32, device=x.device)
    fn = _build.function(_LIB, "estimator_mlp_f32", _ARGTYPES, x.device)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                b2.data_ptr(), out.data_ptr(), B, F, H, plan.cs, plan.tb, plan.grid,
                plan.slab_rows, plan.smem, _build.stream_ptr(x.device))
    _build.check(rc, _LIB, "estimator_mlp")
    estimator_mlp.launches += 1
    key = f"B={B} F={F} H={H}" + (f" of={whole}" if whole is not None else "")
    estimator_mlp.launches_by_shape[key] = estimator_mlp.launches_by_shape.get(key, 0) + 1
    return out


estimator_mlp.launches = 0
estimator_mlp.launches_by_shape = {}
