"""Run one cell of the port's benchmark once, on the card it starts on.

    python bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``src/repro_torch``.  The cell is
resolved from ``BENCHMARK.json`` and the files under ``bench/``; its
weights, traffic and decision stack come from ``--seed``.  The last line
on stdout is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared beside its limit); the same numbers are
the last lines on stderr.  With ``--trace 0`` the metrics are the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read under
``torch.profiler``.

Exits non-zero and prints no result when no CUDA card is visible, when
fewer cards are visible than the cell asks for, or when ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` was imported.  Kernel
and compiler caches stay inside the checkout (``src/repro_torch/kernels/build``,
the program's own; ``bench/.cache`` for any other).
"""
import time

T_PROCESS = time.perf_counter()  # before the imports: they count in setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _paths() -> None:
    for p in (str(ROOT / "src"), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)
    cache = BENCH / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules():
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``repro_torch`` is not ``repro``)."""
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded.intersection(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    import torch

    from harness.manifest import load_cell
    from harness.runner import run

    cell = load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); {n} visible", file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                 T_PROCESS)
    found = forbidden_modules()
    if found:
        print(f"the run imported {', '.join(found)}; the benchmark must not", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
