"""Isolation: nothing a run loads imports JAX or the JAX package, and the
reference imports nothing of the program.  Names are compared by their top
level (before the first dot), whole: ``repro_torch`` is not ``repro``."""
import ast
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from portbench_util import BENCH, ROOT, tiny_root

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
REFERENCE_MAY_IMPORT = {"__future__", "contextlib", "typing", "numpy", "torch", "reference"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert set(_imports(path)) <= REFERENCE_MAY_IMPORT


@pytest.mark.parametrize("path", sorted(p for d in ("harness", "metrics", "drivers")
                                        for p in (BENCH / d).glob("*.py")) + [BENCH / "run.py"],
                         ids=lambda p: p.name)
def test_harness_sources_import_no_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    sys.path.insert(0, str(BENCH))
    import run as bench_run

    monkeypatch.setitem(sys.modules, "repro_torchish", object())
    monkeypatch.setitem(sys.modules, "jaxtools.x", object())
    assert bench_run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.api", object())
    monkeypatch.setitem(sys.modules, "jaxlib.xla", object())
    assert bench_run.forbidden_modules() == ["jaxlib", "repro"]


def test_a_run_loads_no_jax(tmp_path):
    """A whole run in a fresh process (CPU, tiny cell) leaves no JAX module
    and no ``repro`` module in ``sys.modules``."""
    root = tiny_root(tmp_path / "root", [("qwen2", "float32")])
    code = textwrap.dedent(f"""
        import json, sys, time
        sys.path[:0] = [{str(ROOT / 'src')!r}, {str(BENCH)!r}]
        import torch
        from harness.manifest import load_cell
        from harness.runner import run
        res = run(load_cell({str(root)!r}, 'tiny-qwen2-float32.tiny'), 7, 0.2, True,
                  torch.device('cpu'), time.perf_counter())
        import run as bench_run
        print(json.dumps({{'correct': res['correct'], 'found': bench_run.forbidden_modules()}}))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"correct": True, "found": []}


def test_run_without_a_card_exits_nonzero_with_no_result():
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "qwen2-7b.score-long",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_with_only_the_benchmark_exits_nonzero(tmp_path):
    """A directory holding only BENCHMARK.json and bench/ (no program)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "qwen2-7b.score-long",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert json.loads((tmp_path / "BENCHMARK.json").read_text())["paths"] == ["bench"]
