"""Per-kernel launch and build accounting with zero hot-path cost — the
port's counterpart of ``repro.obs.jit_stats``.

JAX retraces a jitted function once per new shape; the port has no tracer,
its cost centres are the hand-written kernels.  Every wrapper already counts
its own launches (``estimator_mlp.launches`` and the same on the other five,
incremented where the kernel is launched and nowhere else), and
``kernels/_build.py:build_all`` counts each library it compiles in
``_build.BUILDS``.  So nothing here wraps a call: :func:`snapshot` reads
those counters on demand and :func:`delta` diffs two snapshots, the way a
bench or a serve run reports "this phase launched N kernels":

    before = kernel_stats.snapshot()
    run()
    print(kernel_stats.delta(before, kernel_stats.snapshot()))

On the CPU the wrappers take their plain versions and count nothing, so
every launch count stays 0 there.

A call site whose work is several launches or none (the sharded plane's
``fleet_plane.score``: one launch a shard on the card, the plain version on
the CPU) counts its calls itself with :func:`count_call`; ``snapshot`` reads
those beside the launches, as ``repro.obs.jit_stats`` reads its
``count_call`` sites.

The counters are process-global (module-level wrappers are shared by every
engine), so per-run scoping is by snapshot-delta:
:class:`~repro_torch.obs.Obs` captures a baseline at construction and exports
``current - baseline``.
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

#: the wrappers whose launches are counted, as ``(module, function)``
KERNELS: Tuple[Tuple[str, str], ...] = (
    ("repro_torch.kernels.iou_matrix", "iou_matrix"),
    ("repro_torch.kernels.iou_matrix", "iou_matrix_batch"),
    ("repro_torch.kernels.estimator_mlp", "estimator_mlp"),
    ("repro_torch.kernels.score_pipeline", "score_pipeline"),
    ("repro_torch.kernels.flash_sdpa", "flash_sdpa"),
    ("repro_torch.kernels.wkv6", "wkv6"),
)

Snapshot = Dict[str, Dict[str, int]]

#: calls counted by their sites (:func:`count_call`), by site name
CALLS: Dict[str, int] = {}


def count_call(site: str, n: int = 1) -> None:
    """Count ``n`` calls of ``site`` (a dict update: no device work)."""
    CALLS[site] = CALLS.get(site, 0) + n


def snapshot() -> Snapshot:
    """``{"launches": {kernel: n}, "builds": {source: n}, "calls": {site:
    n}}`` — the wrappers' launch counters, the libraries ``build_all`` has
    compiled in this process, and the calls of the sites that count their
    own."""
    from repro_torch.kernels import _build

    return {
        "launches": {
            name: int(getattr(importlib.import_module(module), name).launches)
            for module, name in KERNELS
        },
        "builds": dict(_build.BUILDS),
        "calls": dict(CALLS),
    }


def delta(before: Snapshot, after: Snapshot) -> Snapshot:
    """Per-counter growth between two snapshots.  Keys new in ``after``
    count from zero."""
    return {
        part: {key: n - before[part].get(key, 0) for key, n in after[part].items()}
        for part in after
    }
