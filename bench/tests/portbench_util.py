"""Shared helpers of the benchmark's CPU tests: the import paths, and tiny
cells written from files alone into a scratch root (a configuration, a
traffic mix, limits and a manifest entry each, beside copies of the metric
readers and the drivers), which the harness resolves by name like the real
ones."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
for _p in (str(ROOT / "src"), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

TINY_LIMITS = {"sample_batches": 2, "nll_weak_gap": 1e-4, "nll_strong_gap": 1e-4, "nll_weak_rms": 1e-4,
               "nll_strong_rms": 1e-4, "nll_final_rms": 1e-4, "policy_errors": 0,
               "decision_flips": 0, "logit_margin_gap": 1e-2, "flip_band_logit": 1e-2}


def tiny_model(family: str, dtype: str = "float32") -> dict:
    """A configuration file of ``family`` (``qwen2`` / ``rwkv6``) cut to a
    CPU test's size, from the real file's sections."""
    src = {"qwen2": "qwen2-7b", "rwkv6": "rwkv6-1.6b"}[family]
    conf = json.loads((BENCH / "configs" / f"{src}.json").read_text())
    name = f"tiny-{family}-{dtype}"
    small = dict(name=name, num_layers=2, d_model=128, num_heads=4, head_dim=32, d_ff=256,
                 vocab_size=512, dtype=dtype)
    small["num_kv_heads"] = 2 if family == "qwen2" else 4
    if family == "rwkv6":
        small.update(rwkv_head_size=32, d_ff=448)
    conf["model"].update(small)
    conf["name"] = name
    conf["cascade"]["exit_layer"] = 1
    return conf


TINY_MIX = {"driver": "lm_cascade", "batch": 3,
            "lengths": {"dist": "lognormal", "median": 30, "sigma": 0.8, "min": 20, "max": 70},
            "pad_multiple": 16, "block_batches": 4, "pool_blocks": 2, "layout_seed": 0,
            "calibration_blocks": 1, "ratio": 0.25,
            "tokens": {"zipf_vocab": 4096, "zipf_power": 1.1, "copy_prob": 0.5}}


def tiny_root(tmp: Path, cells, limits=None) -> Path:
    """A checkout-like root with the real manifest's metrics and one tiny
    cell per (family, dtype) in ``cells``, each named
    ``tiny-<family>-<dtype>.tiny``."""
    tmp = Path(tmp)
    (tmp / "bench").mkdir(parents=True, exist_ok=True)
    for d in ("metrics", "drivers"):
        shutil.copytree(BENCH / d, tmp / "bench" / d, dirs_exist_ok=True)
    for d in ("configs", "traffic", "limits"):
        (tmp / "bench" / d).mkdir(exist_ok=True)
    (tmp / "bench" / "traffic" / "tiny.json").write_text(json.dumps(TINY_MIX))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    man["configs"], man["workloads"] = [], []
    for family, dtype in cells:
        conf = tiny_model(family, dtype)
        path = f"bench/configs/{conf['name']}.json"
        (tmp / path).write_text(json.dumps(conf))
        man["configs"].append({"name": conf["name"], "source": conf["source"], "file": path,
                               "reduced": ["num_layers"], "why": "CPU test"})
        cell = f"{conf['name']}.tiny"
        man["workloads"].append({"name": cell, "config": conf["name"], "traffic": "tiny",
                                 "chips": 1, "why": "CPU test"})
        (tmp / "bench" / "limits" / f"{cell}.json").write_text(json.dumps(limits or TINY_LIMITS))
    names = [w["name"] for w in man["workloads"]]
    for m in man["per_layer"]:
        m["workloads"] = names
    (tmp / "BENCHMARK.json").write_text(json.dumps(man))
    return tmp
