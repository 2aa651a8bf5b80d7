"""BENCHMARK.json against the benchmark contract, and every cell's files
found by name."""
import json
import re

import pytest

from portbench_util import BENCH, ROOT

from harness import check
from harness.manifest import NAME, UNIT, driver, load_cell, manifest, reader

MAN = manifest(ROOT)
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "bench/run.py"]
    assert MAN["paths"] == ["bench"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fits_the_full_budget():
    s = MAN["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    runs = 2 + 14 * 24
    assert runs * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_keys(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for key in ("why", "layer", "source"):
        if isinstance(entry.get(key), str):
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


def test_unique_names():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
        assert set(m.get("workloads", ())) <= set(CELLS)


def test_every_config_used():
    assert {c["name"] for c in MAN["configs"]} == {w["config"] for w in MAN["workloads"]}


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = load_cell(ROOT, name)
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(reader(ROOT, m["name"]))
    assert callable(driver(cell))
    compared = set(cell.limits) - {"flip_band_logit", "sample_batches"}
    assert cell.limits["sample_batches"] >= 2
    assert compared <= set(check.NUMBERS) and cell.limits["flip_band_logit"] > 0
    assert {"nll_weak_rms", "nll_strong_rms", "nll_final_rms", "policy_errors",
            "decision_flips"} <= compared
    assert cell.limits["decision_flips"] == cell.limits["policy_errors"] == 0
    assert (BENCH / "reference" / f"{cell.config['reference']}.py").is_file()
    assert cell.config["model"]["name"] == cell.workload["config"]


def test_configs_keep_published_widths():
    """Nothing is cut: the model section matches the published sizes."""
    q = json.loads((BENCH / "configs" / "qwen2-7b.json").read_text())
    p, m = q["published"], q["model"]
    assert (m["d_model"], m["d_ff"], m["num_layers"], m["num_heads"], m["num_kv_heads"],
            m["vocab_size"]) == (p["hidden_size"], p["intermediate_size"], p["num_hidden_layers"],
                                 p["num_attention_heads"], p["num_key_value_heads"], p["vocab_size"])
    assert m["d_model"] == m["num_heads"] * m["head_dim"]
    r = json.loads((BENCH / "configs" / "rwkv6-1.6b.json").read_text())
    p, m = r["published"], r["model"]
    assert (m["d_model"], m["d_ff"], m["num_layers"], m["rwkv_head_size"], m["vocab_size"]) == (
        p["n_embd"], p["dim_ffn"], p["n_layer"], p["head_size_a"], p["vocab_size"])


def test_files_under_paths_are_named_from_name_characters():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts or ".cache" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
