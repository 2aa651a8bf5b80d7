"""Whole runs on the CPU at a small size, through the same code as a run on
the card below its check for a card: a cell added from files alone, the
traced run, the faults that must turn ``correct`` false, and the
lower-precision control."""
import time

import numpy as np
import pytest
import torch

from portbench_util import tiny_root

from harness import check
from harness.manifest import driver, load_cell
from harness.runner import run

CPU = torch.device("cpu")
SEED = 2_147_483_659  # past 32 signed bits


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"),
                     [("qwen2", "float32"), ("rwkv6", "float32")])


@pytest.mark.parametrize("name", ["tiny-qwen2-float32.tiny", "tiny-rwkv6-float32.tiny"])
@pytest.mark.parametrize("traced", [False, True])
def test_cell_from_files_alone_runs_correct(root, name, traced):
    cell = load_cell(root, name)
    res = run(cell, SEED, 0.3, traced, CPU, time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    want = {m["name"] for m in (cell.per_layer if traced else cell.end_to_end)}
    # the CPU has no device trace and no card peak: those metrics stay out
    device_only = {"flash_sdpa_roofline", "wkv6_roofline", "device_idle_share", "mfu"}
    assert set(res["metrics"]) == want - device_only
    if traced:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert res["device"]["window_s"] > 0


def _fault_add_to_one_answer(monkeypatch):
    import repro_torch.serving.cascade_serving as cs

    real = cs.sequence_nll

    def altered(logits, labels):
        out = real(logits, labels).clone()
        out[0] += 0.05
        return out

    monkeypatch.setattr(cs, "sequence_nll", altered)


def _fault_half_batch(monkeypatch):
    import repro_torch.serving.cascade_serving as cs

    real = cs.forward

    def half(params, cfg, batch, **kw):
        n = batch["tokens"].shape[0]
        keep = {k: v[: (n + 1) // 2] for k, v in batch.items()}
        logits, aux = real(params, cfg, keep, **kw)
        idx = torch.arange(n) % logits.shape[0]
        return logits[idx], aux

    monkeypatch.setattr(cs, "forward", half)


def _fault_layer_unchanged(monkeypatch):
    import repro_torch.models.lm as lm

    monkeypatch.setattr(lm, "_dense_block", lambda lp, cfg, h, *a, **k: (h, None))
    monkeypatch.setattr(lm, "_rwkv_block", lambda lp, cfg, h, s, xt, xc, plain=False:
                        (h, s, xt, xc))


def _fault_decision_altered(monkeypatch):
    from repro_torch.api.engine import OffloadEngine

    real = OffloadEngine.decide

    def flipped(self, *a, **k):
        out = real(self, *a, **k)
        out.offload[-1] = not out.offload[-1]
        return out

    monkeypatch.setattr(OffloadEngine, "decide", flipped)


def _fault_no_standardisation(monkeypatch):
    from repro_torch.api import reward_model as rm

    def raw(self, x):
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        p = self.pipeline_params()
        return rm.estimator_mlp(x.contiguous(), p["w1"], p["b1"], p["w2"], p["b2"])

    monkeypatch.setattr(rm.MLPRewardModel, "predict_device", raw)


FAULTS = {"answer altered": _fault_add_to_one_answer, "half the batch": _fault_half_batch,
          "a layer returns its state unchanged": _fault_layer_unchanged,
          "a decision altered": _fault_decision_altered,
          "the head run without standardisation": _fault_no_standardisation}


@pytest.mark.parametrize("name", ["tiny-qwen2-float32.tiny", "tiny-rwkv6-float32.tiny"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_turns_correct_false(root, name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = run(load_cell(root, name), SEED, 0.3, False, CPU, time.perf_counter())
    assert not res["correct"], res["checks"]
    caught_by = {"a decision altered": "policy_errors",
                 "the head run without standardisation": "logit_margin_gap"}.get(fault)
    if caught_by:
        c = res["checks"][caught_by]
        assert c["value"] > c["limit"], res["checks"]


@pytest.mark.parametrize("family", ["qwen2", "rwkv6"])
def test_fp8_control_reads_far_above_bf16(tmp_path, family):
    """The control (the reference in fp8 in the program's place) against
    the bf16 program on the same seeds and prompts, at a CPU test's size:
    its worst number reads at least three times the program's, and limits
    set between the two fail it."""
    root = tiny_root(tmp_path, [(family, "bfloat16")])
    cell = load_cell(root, f"tiny-{family}-bfloat16.tiny")
    for seed in (SEED, SEED + 1):
        drv = driver(cell)(cell, seed, CPU)
        drv.setup()
        drv.window(0.3)
        drv.free()
        idx = drv.sample()
        refr = drv.reference_answers(idx)
        band = cell.limits["flip_band_logit"]
        prog = check.readings(drv.program_answers(idx), refr, band)
        ctrl = check.readings(drv.reference_answers(idx, "fp8"), refr, band)
        keys = ("nll_weak_rms", "nll_strong_rms", "nll_final_rms")
        assert max(ctrl[k] / max(prog[k], 1e-12) for k in keys) >= 3, (prog, ctrl)
        limits = {k: 2 * prog[k] for k in keys}
        assert all(c["ok"] for c in check.judge(prog, limits).values())
        assert not all(c["ok"] for c in check.judge(ctrl, limits).values())
        assert np.isfinite(list(ctrl.values())).all()


TOY_DRIVER = '''
import time

import numpy as np


class Driver:
    """Serves a batch by summing its rows on the device; the check compares
    each sum with numpy's."""

    def __init__(self, cell, seed, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.rows = int(cell.traffic["rows"])

    def setup(self):
        self.setup_parts = {}
        self.data = np.random.default_rng(self.seed).normal(size=(self.rows, 64))

    def window(self, seconds, stage_ms=None):
        import torch

        records, self.sums = [], []
        t_start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            self.sums.append(torch.as_tensor(self.data, device=self.device).sum(1).cpu().numpy())
            t1 = time.perf_counter()
            records.append({"t0": t0 - t_start, "t1": t1 - t_start, "rows": self.rows,
                            "scored": self.rows, "lengths": [1] * self.rows, "pad": 1})
            if t1 - t_start >= seconds:
                return {"records": records, "window_s": t1 - t_start}

    def failed(self):
        return 0

    def free(self):
        pass

    def model_flops(self, records):
        return None

    def readings(self):
        gap = max(float(np.abs(s - self.data.sum(1)).max()) for s in self.sums)
        return {"values": {"sum_gap": gap}, "diag": {}}
'''


def test_a_cell_of_another_kind_from_files_alone(tmp_path):
    """A driver, a traffic mix that names it, a configuration, limits and a
    manifest entry, all new files: the harness runs the cell unedited."""
    import json

    root = tiny_root(tmp_path, [("qwen2", "float32")])
    (root / "bench" / "drivers" / "toy_sum.py").write_text(TOY_DRIVER)
    (root / "bench" / "traffic" / "toy.json").write_text(json.dumps({"driver": "toy_sum",
                                                                     "rows": 5}))
    (root / "bench" / "configs" / "toy.json").write_text(json.dumps({"name": "toy"}))
    (root / "bench" / "limits" / "toy.sum.json").write_text(json.dumps({"sum_gap": 1e-9}))
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "toy", "source": "https://numpy.org", "reduced": [],
                           "file": "bench/configs/toy.json", "why": "CPU test"})
    man["workloads"].append({"name": "toy.sum", "config": "toy", "traffic": "toy", "chips": 1,
                             "why": "CPU test"})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    res = run(load_cell(root, "toy.sum"), SEED, 0.05, False, CPU, time.perf_counter())
    assert res["correct"] and res["checks"]["sum_gap"]["limit"] == 1e-9
    assert {"scored_tokens_per_s", "request_ms_p90", "setup_s"} <= set(res["metrics"])
