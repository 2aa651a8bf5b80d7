"""The port's single-card dry run against the JAX package's dry-run inputs,
on the CPU: for every architecture x assigned shape (10 x 4), the shapes and
dtypes of ``input_specs``, ``abstract_params`` and ``abstract_opt_state``
equal ``repro``'s ``ShapeDtypeStruct``s, with one stated mapping: ``repro``'s
int32 (token ids, labels, M-RoPE ids, the decode position, the AdamW step)
is the port's int64.  Every spec is a meta tensor (nothing allocated).
``model_flops`` equals ``repro.launch.dryrun.model_flops``, read from a
subprocess: that module forces 512 host devices when it is imported, which a
test process must not do.  The entry point runs here and reads the card's
rates from the H100 data sheet."""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (first: it imports repro.detection before repro's kernels)
from repro.configs import get_config as j_get_config
from repro.launch import input_specs as j_specs
from repro.launch.steps import abstract_opt_state as j_abstract_opt_state
from repro.models import lm as jlm

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.input_specs import SHAPES, input_specs
from repro_torch.launch.steps import abstract_opt_state
from repro_torch.models import lm as tlm
from repro_torch.train.adamw import AdamWState

ROOT = Path(__file__).resolve().parents[1]
CASES = [(a, s) for a in ARCH_IDS for s in SHAPES]
INT_MAP = {"int32": "int64"}  # repro's index type -> the port's


def signature(tree):
    """Nested (shape, dtype name) of a tree of ShapeDtypeStructs or meta
    tensors (dicts, NamedTuples), repro's int32 named int64; a plain int or
    str (the decode capacity, the kind) as itself."""
    if isinstance(tree, dict):
        return {k: signature(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(signature(v) for v in tree)
    if isinstance(tree, (int, str)):
        return tree
    if isinstance(tree, torch.Tensor):
        assert tree.device.type == "meta", tree.device
        return tuple(tree.shape), str(tree.dtype).removeprefix("torch.")
    name = str(np.dtype(tree.dtype))
    return tuple(tree.shape), INT_MAP.get(name, name)


@functools.lru_cache(maxsize=None)
def repro_params(arch):
    return jlm.abstract_params(j_get_config(arch))


@functools.lru_cache(maxsize=None)
def port_params(arch):
    return tlm.abstract_params(get_config(arch))


@pytest.mark.parametrize("arch,shape", CASES)
def test_specs_params_and_opt_state_equal_repro(arch, shape):
    jcfg, jspecs = j_specs.input_specs(arch, shape)
    tcfg, tspecs = input_specs(arch, shape)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert signature(tspecs) == signature(jspecs)
    params = port_params(arch)
    assert signature(params) == signature(repro_params(arch))
    assert {t.dtype for t in tlm.tree_leaves(params)} == {tcfg.act_dtype}
    if tspecs["kind"] == "train":
        opt = abstract_opt_state(params)
        assert isinstance(opt, AdamWState)
        assert signature(opt) == signature(j_abstract_opt_state(repro_params(arch)))


@pytest.fixture(scope="module")
def repro_flops():
    """repro's model_flops and recurrence_flops (one pod) of every case,
    from a subprocess."""
    code = ("import json\n"
            "from repro.launch.dryrun import model_flops, recurrence_flops\n"
            "from repro.launch.input_specs import SHAPES, resolve_config\n"
            "from repro.configs import ARCH_IDS\n"
            "print(json.dumps({a + '/' + s: [model_flops(resolve_config(a, s), s),\n"
            "                  recurrence_flops(resolve_config(a, s), s, False)]\n"
            "                  for a in ARCH_IDS for s in SHAPES}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,shape", CASES)
def test_model_flops_equal_repro(repro_flops, arch, shape):
    """model_flops exactly; recurrence_flops over the whole batch, where
    repro's one-pod figure is a sixteenth of it when 16 divides the batch
    (its batch shards)."""
    cfg, _ = input_specs(arch, shape)
    want_flops, want_rec = repro_flops[f"{arch}/{shape}"]
    assert dryrun.model_flops(cfg, shape) == want_flops > 0
    shards = 16 if SHAPES[shape]["batch"] % 16 == 0 else 1
    assert dryrun.recurrence_flops(cfg, shape) == want_rec * shards
    assert (want_rec > 0) == (cfg.arch_type in ("rwkv", "hybrid"))


def test_report_bytes_and_roofline():
    """The report's arguments are the meta tensors' bytes: whisper-base's
    decode_32k cache is (k, v, xk, xv) in bf16; a train step adds the two
    AdamW moments and the step; the roofline divides by the data sheet."""
    card = dryrun.card_spec()
    rep = dryrun.report("whisper_base", "decode_32k", card)
    L, B, C, F, K, D = 6, 128, 32768, 1500, 8, 64
    assert rep["argument_bytes"]["cache"] == 2 * (2 * L * B * C * K * D + 2 * L * B * F * K * D)
    assert rep["argument_bytes"]["token_and_pos"] == 8 * (B + 1)
    params = sum(t.numel() for t in tlm.tree_leaves(port_params("whisper_base")))
    assert 70e6 < params < 75e6 and rep["argument_bytes"]["params"] == 2 * params
    total = rep["argument_bytes"]["total"]
    assert total == sum(v for k, v in rep["argument_bytes"].items() if k != "total")
    assert rep["fits_one_card"] == (total <= card["memory_bytes"])
    assert rep["roofline"]["memory_s"] == total / 3.35e12
    assert rep["roofline"]["compute_s"] == rep["model_flops"] / 989e12
    assert rep["roofline"]["dominant"] == "memory_s"
    train = dryrun.report("qwen2_7b", "train_4k", card)
    assert train["argument_bytes"]["opt_state"] == 2 * train["argument_bytes"]["params"] + 8
    assert train["roofline"]["dominant"] == "compute_s"
    big = dryrun.report("qwen1_5_32b", "decode_32k", card)  # a 32k cache of 64 layers: 5.6 TB
    assert not big["fits_one_card"]


def test_nothing_is_allocated():
    """abstract_params, init_cache and the specs stay on meta; the kernels'
    path resolution still refuses meta."""
    from repro_torch.kernels.dispatch import resolve_device, resolve_path

    _, specs = input_specs("qwen1_5_32b", "decode_32k")
    assert all(t.device.type == "meta" for t in specs["cache"].values())
    assert resolve_device("meta", allow_meta=True).type == "meta"
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_path(specs["tokens"])


def test_dryrun_entry_point_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "yi_6b",
                          "--shape", "train_4k"], env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    rep = json.loads(lines[0])
    assert (rep["arch"], rep["shape"], rep["kind"], rep["fits_one_card"]) == ("yi_6b", "train_4k",
                                                                               "train", True)
    assert rep["card"] == {"memory_bytes": 80e9, "memory_source": "NVIDIA H100 SXM data sheet",
                           "hbm_bytes_per_s": 3.35e12, "bf16_flops_per_s": 989e12,
                           "rates_source": "NVIDIA H100 SXM data sheet"}
    everything = dryrun.main(["--all"])
    assert [(r["arch"], r["shape"]) for r in everything] == CASES
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "yi_6b"])
