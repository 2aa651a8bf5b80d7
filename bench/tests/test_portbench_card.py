"""Card tests (marked ``gpu``; they skip without a CUDA card): every cell
of BENCHMARK.json once, short, through ``bench/run.py``, with ``correct``
true and its result line well formed.  On the card:

    python -m pytest -q -m gpu bench/tests/test_portbench_card.py
"""
import json
import subprocess
import sys

import pytest

from portbench_util import ROOT

from harness.manifest import manifest

CELLS = [w["name"] for w in manifest(ROOT)["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(card, name):
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", name, "--seed",
                          "2147483777", "--seconds", "3", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert {"scored_tokens_per_s", "request_ms_p90", "setup_s"} <= set(res["metrics"])
