"""One run of one cell: set-up, the window (traced or not), the metrics,
then the check.  ``bench/run.py`` calls :func:`run` on the card; the tests
call it on the CPU at a small size, with the same code below the card
check.

The cell's driver (``harness.manifest.driver``) does what is particular to
the system it serves: ``Driver(cell, seed, device)``; ``setup()`` (filling
``setup_parts``); ``window(seconds, stage_ms=None)``, which returns the
window's ``records`` (one a batch: ``t0`` / ``t1`` in seconds from the
window's start, ``rows``, ``scored``, ``lengths``, ``pad``) and its
``window_s``; ``failed()``; ``free()``, which drops the program's state;
``readings()``, which returns the ``values`` that ``harness.check`` judges
and a ``diag`` for the run's diagnostic line; and ``model_flops(records)``
(None where it has no count).  The metric readers see the driver as
``ctx.driver``, beside the window's records, the configuration's
``model`` and the driver's ``exit_layer`` (None where it has none)."""
from __future__ import annotations

import json
import statistics
import sys
import time
from types import SimpleNamespace
from typing import Dict

import torch

from harness import check, trace
from harness.manifest import Cell, driver, reader


def _device_info(device: torch.device, chips: int) -> Dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def run(cell: Cell, seed: int, seconds: float, traced: bool, device: torch.device,
        t_process: float) -> Dict:
    """The result line of one run (the keys the contract names, ``checks``
    last).  ``t_process`` is the process's start on ``time.perf_counter``."""
    from repro_torch.obs import kernel_stats

    drv = driver(cell)(cell, seed, device)
    t_setup = time.perf_counter()
    drv.setup()
    drv.setup_parts["before_setup_s"] = t_setup - t_process
    setup_s = time.perf_counter() - t_process
    before = kernel_stats.snapshot()
    stage_ms = {} if traced else None
    reduced = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(trace.WINDOW):
                win = drv.window(seconds, stage_ms)
        reduced = trace.reduce(prof)
        del prof
    else:
        win = drv.window(seconds)
    launches = kernel_stats.delta(before, kernel_stats.snapshot())["launches"]
    dev_info = _device_info(device, cell.chips)
    ctx = SimpleNamespace(cell=cell, driver=drv, model=cell.config.get("model"),
                          exit_layer=getattr(drv, "exit_layer", None),
                          records=win["records"], window_s=win["window_s"], setup_s=setup_s,
                          stage_ms=stage_ms, trace=reduced, launches=launches,
                          on_card=device.type == "cuda")
    wanted = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = reader(cell.root, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    failed = drv.failed()
    attempted = sum(r["rows"] for r in win["records"])
    drv.free()
    read = drv.readings()
    values = read["values"]
    lat = [r["t1"] - r["t0"] for r in win["records"]]
    print(json.dumps({"diag": {
        "setup_s": setup_s, "setup_parts": drv.setup_parts, "batches": len(lat),
        "window_s": win["window_s"],
        "batch_ms_min_median_max": [1e3 * min(lat), 1e3 * statistics.median(lat), 1e3 * max(lat)],
        "readings": values, "launches": {k: v for k, v in launches.items() if v},
        **read["diag"]}}), file=sys.stderr)
    checks = check.judge(values, cell.limits)
    result = {"correct": failed == 0 and all(c["ok"] for c in checks.values()),
              "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev_info}
    if traced:
        dev_info["busy_s"] = reduced["busy_s"]
        dev_info["window_s"] = reduced["window_s"]
        result["breakdown"] = reduced["breakdown"]
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    check.report(values, checks)
    return result
