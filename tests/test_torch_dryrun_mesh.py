"""The dry run's multi-device half on a fake process group, in a
subprocess (a process group is process-global): a reduced dense config
(float32, kv heads = heads = 4, no context parallelism) on a (1, 4) mesh of
("data", "model").

* The forward's per-device FLOPs equal the column / row-parallel count of
  rank 0's shard (each projection, the attention core and the logits over
  4), and its all-reduce bytes are two all-reduces of B x S x M float32 a
  layer (after ``wo`` and after the MLP's ``down``), nothing else reduced.
* The two-depth extrapolation (depths 2 and 4, to 6) equals the step
  traced at depth 6, exactly, in FLOPs, bytes and collective bytes.
* ``dryrun_one``'s ``model_flops_ratio`` is in (0, 1.5], and its JSON
  carries every field of ``repro``'s ``dryrun_one`` (read from its source).
* Every architecture's step, reduced, traces at every assigned shape on a
  (2, 2) mesh (batch and model both sharded), with FLOPs and, past the
  decode steps of one sequence, collectives.
"""
import ast
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.configs import ARCH_IDS
from repro_torch.launch.input_specs import SHAPES

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 16

SCRIPT = textwrap.dedent(f"""
    import dataclasses, json
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.dispatch import meta_reference
    from repro_torch.launch import dryrun as D, mesh as M, sharding as SH
    from repro_torch.launch.meshctx import bind_mesh
    from repro_torch.models import lm

    D.init_fake_group(4)
    mesh = M.make_mesh((1, 4), ("data", "model"), device_type="cpu")
    mapping = M.logical_axes()
    small = {{f.name: getattr(lm.reduced(get_config("yi_6b"), num_kv_heads=4), f.name)
             for f in dataclasses.fields(lm.LMConfig) if f.name != "name"}}
    small["attn_seq_shard"] = False
    cfg = dataclasses.replace(get_config("yi_6b"), **small)
    out = {{"cfg": {{k: getattr(cfg, k) for k in ("num_layers", "d_model", "num_heads",
           "num_kv_heads", "head_dim", "d_ff", "vocab_size")}}}}
    params = lm.abstract_params(cfg)
    batch = {{"tokens": torch.empty(({B}, {S}), dtype=torch.int64, device="meta")}}
    with bind_mesh(mesh, mapping), meta_reference():
        p = SH.distribute(params, SH.param_shardings(params, mesh, mapping))
        b = SH.distribute(batch, SH.batch_shardings(batch, mesh, mapping))
        with D.LocalCost(mesh) as cost:
            lm.forward(p, cfg, b)
    out["forward"] = cost.totals()
    over = dict(small, num_layers=6)
    probe = D.cost_probe("yi_6b", "train_4k", mesh, mapping, over)
    out["extrapolated"] = probe["full"]
    out["depths"] = probe["depths"]
    full = D.trace_step(D._probe_cfg(D._config("yi_6b", "train_4k", over), 6), "train_4k",
                        mesh, mapping)
    out["traced"] = full.totals()
    out["one"] = D.dryrun_one("yi_6b", "train_4k", False, mesh, overrides=small)
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch.input_specs import SHAPES
    mesh22 = M.make_mesh((2, 2), ("data", "model"), device_type="cpu")
    out["families"] = {{}}
    for arch in ARCH_IDS:
        for shape in SHAPES:
            cfg = lm.reduced(D._config(arch, shape, None), scan_chunk=1024)
            try:
                out["families"][f"{{arch}}/{{shape}}"] = D.trace_step(cfg, shape, mesh22,
                                                                      mapping).totals()
            except Exception as e:
                out["families"][f"{{arch}}/{{shape}}"] = f"{{type(e).__name__}}: {{e}}"
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def result():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    line = [x for x in run.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def test_forward_flops_and_all_reduces_are_the_tensor_parallel_count(result):
    c = result["cfg"]
    L, M, H, K, D, F, V = (c[k] for k in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                                          "head_dim", "d_ff", "vocab_size"))
    n, T = 4, B * S
    per_layer = (2 * T * M * H * D + 2 * 2 * T * M * K * D  # q, k, v (columns over n)
                 + 2 * 2 * B * S * S * H * D  # q k^T and p v (heads over n)
                 + 2 * T * H * D * M  # wo (rows over n)
                 + 3 * 2 * T * M * F) / n  # gate, up, down
    want = L * per_layer + 2 * T * M * V / n  # logits (vocab over n)
    fwd = result["forward"]
    assert fwd["flops"] == want
    assert fwd["coll:all-reduce"] == L * 2 * T * M * 4
    assert fwd["count:all-reduce"] == 2 * L
    assert fwd["coll:reduce-scatter"] == 0 and fwd["coll:all-to-all"] == 0
    assert fwd["axis:model"] == fwd["coll"] and fwd["axis:data"] == 0


def test_depth_extrapolation_equals_the_full_depth_trace(result):
    assert tuple(result["depths"]) == (2, 4)
    got, want = result["extrapolated"], result["traced"]
    assert set(got) == set(want)
    for key in ("flops", "bytes", "coll", "coll:all-reduce", "coll:all-gather", "axis:model"):
        assert got[key] == want[key], key
    assert want["flops"] > 0 and want["coll"] > 0


def test_model_flops_ratio_in_range(result):
    one = result["one"]
    assert 0 < one["model_flops_ratio"] <= 1.5
    assert one["mesh"] == "1x4" and one["devices"] == 4
    assert one["per_device"]["depth_corrected"]
    r = one["roofline"]
    assert r["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert r["collective_s"] == pytest.approx(r["collective_model_s"] + r["collective_other_s"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_family_traces_on_a_2x2_mesh(result, arch):
    for shape in SHAPES:
        got = result["families"][f"{arch}/{shape}"]
        assert isinstance(got, dict), got
        assert got["flops"] > 0 and got["bytes"] > 0, shape
        if shape != "long_500k":  # batch 1: nothing over data; one token: little over model
            assert got["coll"] > 0, shape


def _repro_fields():
    """The keys of the ``result`` dict literal in repro's ``dryrun_one`` (and
    of its nested dict literals), read from the source: importing that module
    forces 512 host devices."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "dryrun_one")
    lit = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "result")

    def keys(d):
        return {k.value: (keys(v) if isinstance(v, ast.Dict) else None)
                for k, v in zip(d.keys, d.values)}

    out = keys(lit)
    out["roofline"]["dominant"] = None  # set after the literal, as here
    out["model_flops_ratio"] = None
    return out


def test_json_carries_repro_fields(result):
    def covers(got, want, where=""):
        for k, sub in want.items():
            assert k in got, f"{where}{k}"
            if sub:
                covers(got[k], sub, f"{where}{k}.")

    covers(result["one"], _repro_fields())
