"""The per-layer metrics that read the program's spans (``decision_ms_p90``,
``features_ms``) in a tiny lm_cascade cell's traced run on the CPU: both
read, the decision comes before the answer and the feature pass inside the
decision, and neither reads when the window's ``cascade.serve_batch``
spans are not one a batch."""
import time
from types import SimpleNamespace

import pytest
import torch

from portbench_util import tiny_root

from harness import manifest, runner
from harness.manifest import load_cell, reader

CPU = torch.device("cpu")
SEED = 2_147_483_661


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One traced run of a tiny qwen2 cell: its result and the context its
    metric readers saw."""
    root = tiny_root(tmp_path_factory.mktemp("tiny"), [("qwen2", "float32")])
    cell = load_cell(root, "tiny-qwen2-float32.tiny")
    seen = {}
    real = manifest.reader

    def keep_ctx(r, name):
        read = real(r, name)

        def wrapped(ctx):
            seen["ctx"], seen["cascade"] = ctx, ctx.driver.cascade
            return read(ctx)
        return wrapped

    mp = pytest.MonkeyPatch()
    mp.setattr(runner, "reader", keep_ctx)
    try:
        res = runner.run(cell, SEED, 0.3, True, CPU, time.perf_counter())
    finally:
        mp.undo()
    ctx = seen["ctx"]
    ctx.driver.cascade = seen["cascade"]  # the run freed it after its readers
    return root, res, ctx


def test_span_metrics_read_in_a_traced_run(traced):
    root, res, ctx = traced
    assert res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["decision_ms_p90"] > 0 and m["features_ms"] > 0
    assert res["metrics"]["decision_ms_p90"]["unit"] == "ms"
    # the decision instant precedes the answer; the feature pass is inside decide
    assert m["decision_ms_p90"] < reader(root, "request_ms_p90")(ctx)
    assert m["features_ms"] <= m["decide_ms"]


@pytest.mark.parametrize("name", ["decision_ms_p90", "features_ms"])
def test_span_metrics_read_nothing_when_the_count_differs(traced, name):
    root, _, ctx = traced
    read = reader(root, name)
    assert read(ctx) is not None
    assert len(ctx.records) > 1
    assert read(SimpleNamespace(**{**vars(ctx), "records": ctx.records[:-1]})) is None
    assert read(SimpleNamespace(**{**vars(ctx), "records": ctx.records + ctx.records[-1:]})) is None


@pytest.mark.parametrize("name", ["decision_ms_p90", "features_ms"])
def test_span_metrics_read_nothing_from_a_program_without_spans(traced, name):
    """A cascade with no ``obs`` (as the program before the spans had none)."""
    root, _, ctx = traced
    bare = SimpleNamespace(**{**vars(ctx), "driver": SimpleNamespace(cascade=object())})
    assert reader(root, name)(bare) is None
