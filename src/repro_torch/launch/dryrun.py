"""Dry run (``repro.launch.dryrun``), in two halves.

The single-card report: for each (architecture x input shape), the bytes of
the step's arguments, summed from meta tensors, whether they fit one card,
the model's FLOPs, and a roofline against the card.

  python -m repro_torch.launch.dryrun --arch yi_6b --shape train_4k
  python -m repro_torch.launch.dryrun --all

Prints one JSON object a line, one per (arch, shape).  Nothing is allocated
and nothing runs on a device: the arguments are ``abstract_params``, plus
``abstract_opt_state`` for a train step and the batch, or the decode cache,
the token and the position for a decode step (``launch.input_specs``).

``model_flops`` is the JAX package's (6 N D for training, 2 N D otherwise,
N the parameters a token touches, D the tokens of the step), and
``recurrence_flops`` its count of the RWKV6 / Mamba2 recurrences, here over
the whole batch on the one card.  The roofline takes ``compute_s`` = model
FLOPs / the bf16 peak and ``memory_s`` = argument bytes / the HBM rate;
``dominant`` is the larger.  The card's memory is
``torch.cuda.get_device_properties`` where a card is visible, else the H100
SXM data sheet's 80 GB; the rates are always the data sheet's (3.35 TB/s,
989 TFLOP/s dense bf16).  Each report names which it used.

The multi-device half (``--mesh``): each step on the production mesh
(``launch.mesh``: 32 x 8 ranks, or 2 x 32 x 8), traced once on rank 0 of a
fake process group of 256 / 512 ranks, on meta tensors (nothing computed,
nothing allocated), with parameters, optimizer state, batch and cache
``DTensor``s by ``launch.sharding``'s rules.

  python -m repro_torch.launch.dryrun --mesh single_pod --arch qwen2_7b --shape train_4k
  python -m repro_torch.launch.dryrun --mesh both --all [--override JSON] [--tag T] [--jobs N]

Where the JAX package lowers and compiles the step for forced host
devices and reads XLA's cost analysis of the partitioned module, the port
counts rank 0's own operations as ``DTensor`` dispatches them (``LocalCost``:
a dispatch mode that lets ``DTensor`` turn each global operation into the
local operations and collectives of rank 0): FLOPs by PyTorch's flop
formulas on the local shapes, bytes as every non-view operation's inputs
read once and outputs written once (unfused eager operations: more than
XLA's fused count), and the functional collectives' result bytes by
``repro``'s five kinds and by mesh axis.  As in ``repro``, the step runs at
two reduced depths (``_probe_depths``) and every count is extrapolated
linearly to the full depth; nothing is traced at full depth.  Kernels take
their plain versions' shapes on meta (``kernels.dispatch.meta_reference``);
``wkv6``'s plain loop over time is replaced by its shapes, and the RWKV6
recurrence's FLOPs are added analytically (``recurrence_flops`` over rank
0's batch shard; the Mamba2 scan is tensor ops, counted as traced).

A line per cell, ``repro``'s ``dryrun_one`` fields with these changes:
``mesh`` is ``"32x8"`` / ``"2x32x8"``; ``compile_s`` is 0 (nothing
compiles; ``lower_s`` is the two traces); ``memory.argument_bytes`` is rank
0's share and ``memory.fits_one_card`` whether it fits one card's 80 GB;
the roofline's ``collective_s`` is the ``model`` axis's bytes at the
NVLink rate plus the other axes' at the InfiniBand rate (``launch.mesh``);
``per_device.collectives_by_axis`` splits the bytes by mesh axis.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_IDS
from repro_torch.kernels.dispatch import meta_reference
from repro_torch.launch import mesh as lmesh
from repro_torch.launch.input_specs import SHAPES, input_specs, resolve_config
from repro_torch.launch.input_specs import specs as step_specs
from repro_torch.launch.meshctx import bind_mesh, constrain
from repro_torch.launch.sharding import (Sharding, _resolve, batch_shardings, cache_shardings,
                                         distribute, param_shardings)
from repro_torch.launch.steps import (abstract_opt_state, make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models.lm import LMConfig, abstract_params, zero_cache
from repro_torch.train.adamw import AdamWState
from repro_torch.tree import tree_leaves, tree_map

DATA_SHEET = "NVIDIA H100 SXM data sheet"
H100_MEMORY_BYTES = 80e9
H100_HBM_BYTES_PER_S = 3.35e12
H100_BF16_FLOPS_PER_S = 989e12  # dense, tensor cores


def model_flops(cfg: LMConfig, shape_name: str) -> float:
    """MODEL_FLOPS = 6·N·D (train) or 2·N·D, N the active parameters a token
    (MoE: shared + top-k experts), D the step's tokens."""
    meta = SHAPES[shape_name]
    D = meta["batch"] * (meta["seq_len"] if meta["kind"] != "decode" else 1)
    M, L = cfg.d_model, cfg.num_layers
    emb = 2 * cfg.vocab_size * M  # embed+unembed
    if cfg.arch_type == "moe":
        if cfg.use_mla:
            attn = M * cfg.num_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim) + \
                M * (cfg.kv_lora_rank + cfg.qk_rope_dim) + \
                cfg.kv_lora_rank * cfg.num_heads * (cfg.qk_nope_dim + cfg.head_dim) + \
                cfg.num_heads * cfg.head_dim * M
        else:
            attn = 2 * M * cfg.num_heads * cfg.head_dim + 2 * M * cfg.num_kv_heads * cfg.head_dim
        ff_act = 3 * M * cfg.d_ff_expert * (cfg.top_k + cfg.num_shared_experts)
        dense_ff = 3 * M * cfg.d_ff
        n_active = (L - cfg.first_k_dense) * (attn + ff_act) + cfg.first_k_dense * (attn + dense_ff) + emb
    elif cfg.arch_type == "rwkv":
        per = 5 * M * M + M * M + 2 * M * cfg.d_ff  # time-mix + channel-mix
        n_active = L * per + emb
    elif cfg.arch_type == "hybrid":
        mc = cfg.mamba()
        per_m = M * (2 * mc.d_inner + 2 * mc.d_state + mc.num_heads) + mc.d_inner * M
        shared = 4 * M * cfg.num_heads * cfg.head_dim + 3 * M * cfg.d_ff
        n_active = cfg.num_mamba_layers * per_m + cfg.num_shared_attn * shared + emb
    elif cfg.arch_type == "encdec":
        per_dec = 8 * M * cfg.num_heads * cfg.head_dim + 2 * M * cfg.d_ff
        per_enc = 4 * M * cfg.num_heads * cfg.head_dim + 2 * M * cfg.d_ff
        n_active = L * per_dec + cfg.encoder_layers * per_enc + emb
    else:  # dense / vlm
        attn = 2 * M * cfg.num_heads * cfg.head_dim + 2 * M * cfg.num_kv_heads * cfg.head_dim
        n_active = L * (attn + 3 * M * cfg.d_ff) + emb
    mult = 6 if meta["kind"] == "train" else 2
    return float(mult) * n_active * D


def recurrence_flops(cfg: LMConfig, shape: str, batch_shards: int = 1) -> float:
    """The RWKV6 / Mamba2 time recurrences' FLOPs (elementwise outer
    products, outside N), over one of ``batch_shards`` shards of the batch
    (the whole batch on one card)."""
    meta = SHAPES[shape]
    B = meta["batch"] / batch_shards
    S = meta["seq_len"] if meta["kind"] != "decode" else 1
    if cfg.arch_type == "rwkv":
        return 8.0 * B * S * cfg.num_layers * cfg.d_model * cfg.rwkv_head_size
    if cfg.arch_type == "hybrid":
        mc = cfg.mamba()
        return 8.0 * B * S * cfg.num_mamba_layers * mc.d_inner * mc.d_state
    return 0.0


def nbytes(tree) -> int:
    """Bytes of the tensors of a (nested dict of) meta tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def card_spec() -> Dict:
    """The card the report is read against: its memory (the visible card's
    when there is one, else the data sheet's) and the data sheet's rates."""
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        memory, source = props.total_memory, f"torch.cuda.get_device_properties(0): {props.name}"
    else:
        memory, source = H100_MEMORY_BYTES, DATA_SHEET
    return {"memory_bytes": memory, "memory_source": source,
            "hbm_bytes_per_s": H100_HBM_BYTES_PER_S, "bf16_flops_per_s": H100_BF16_FLOPS_PER_S,
            "rates_source": DATA_SHEET}


def report(arch: str, shape: str, card: Optional[Dict] = None) -> Dict:
    """The single-card report of one (arch, shape)."""
    card = card or card_spec()
    cfg, specs = input_specs(arch, shape)
    params = abstract_params(cfg)
    args = {"params": nbytes(params)}
    if specs["kind"] == "train":
        opt = abstract_opt_state(params)
        args["opt_state"] = nbytes(opt.step) + nbytes(opt.mu) + nbytes(opt.nu)
    if specs["kind"] == "decode":
        args["cache"] = nbytes(specs["cache"])
        args["token_and_pos"] = nbytes(specs["tokens"]) + nbytes(specs["pos"])
    else:
        args["batch"] = nbytes(specs["batch"])
    total = sum(args.values())
    flops = model_flops(cfg, shape)
    roof = {"compute_s": flops / card["bf16_flops_per_s"],
            "memory_s": total / card["hbm_bytes_per_s"]}
    roof["dominant"] = max(roof, key=roof.get)
    meta = SHAPES[shape]
    return {
        "arch": arch, "shape": shape, "kind": specs["kind"], "batch": meta["batch"],
        "seq_len": meta["seq_len"], "window": cfg.window, "dtype": cfg.dtype,
        "argument_bytes": {**args, "total": total},
        "fits_one_card": total <= card["memory_bytes"],
        "model_flops": flops, "recurrence_flops": recurrence_flops(cfg, shape),
        "roofline": roof, "card": card,
    }


# ---------------------------------------------------------------------------
# the multi-device half: the step on the production mesh, traced on rank 0
# ---------------------------------------------------------------------------

ARTIFACTS = os.path.join(os.path.dirname(__file__), "../../../artifacts/torch_dryrun")

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
#: functional collectives -> repro's HLO names (collective-permute: unused)
FUNCTIONAL_COLLECTIVES = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
                          "reduce_scatter_tensor": "reduce-scatter",
                          "all_to_all_single": "all-to-all"}
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
               "wait_tensor", "_wrap_tensor_autograd", "_local_scalar_dense"}


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(t) for t in x)
    return 0


class LocalCost(TorchDispatchMode):
    """Rank 0's own work while active: a ``DTensor`` operation is handed
    back (``NotImplemented``) so that ``DTensor`` dispatches it as the
    local operations and collectives of this rank, which this mode then
    counts (not the fake-tensor runs of its sharding propagation, which
    see the global shapes).  ``flops``: PyTorch's flop formulas
    (``torch.utils.flop_counter``) on the local shapes; ``bytes``: each
    non-view operation's tensor inputs and outputs; ``collectives`` /
    ``counts`` / ``by_axis``: the functional collectives' result bytes by
    kind and by the mesh axis of their group (``"other"`` for a group that
    is no single axis)."""

    def __init__(self, mesh):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flops = flop_registry
        self.axis_of = {mesh.get_group(i).group_name: name
                        for i, name in enumerate(mesh.mesh_dim_names)}
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives = {c: 0.0 for c in COLLECTIVES}
        self.counts = {c: 0 for c in COLLECTIVES}
        self.by_axis = {**{name: 0.0 for name in mesh.mesh_dim_names}, "other": 0.0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out  # DTensor's sharding propagation, on the global shapes
        name = func._overloadpacket.__name__
        kind = FUNCTIONAL_COLLECTIVES.get(name) if "c10d" in func.namespace else None
        if kind is not None:
            b = _tensor_bytes(out)
            group = args[-1] if isinstance(args[-1], str) else kwargs.get("group_name")
            self.collectives[kind] += b
            self.counts[kind] += 1
            self.by_axis[self.axis_of.get(group, "other")] += b
            return out
        if func._overloadpacket in self._flops:
            self.flops += float(self._flops[func._overloadpacket](*args, **kwargs, out_val=out))
        if not func.is_view and name not in _NO_TRAFFIC and "c10d" not in func.namespace:
            self.bytes += sum(_tensor_bytes(a) for a in args) + _tensor_bytes(out)
        return out

    def totals(self) -> Dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "coll": sum(self.collectives.values()),
                **{f"coll:{k}": v for k, v in self.collectives.items()},
                **{f"count:{k}": float(v) for k, v in self.counts.items()},
                **{f"axis:{k}": v for k, v in self.by_axis.items()}}


def _probe_depths(cfg: LMConfig) -> tuple:
    """Two reduced depths preserving per-layer structure for linear
    extrapolation of cost in depth (see :func:`cost_probe`)."""
    if cfg.arch_type == "hybrid":
        p = cfg.shared_attn_period
        return p, 2 * p  # 1 group, 2 groups
    if cfg.arch_type == "moe" and cfg.first_k_dense:
        return cfg.first_k_dense + 1, cfg.first_k_dense + 2
    return 2, 4


def _probe_cfg(cfg: LMConfig, L: int) -> LMConfig:
    kw = dict(num_layers=L, layer_unroll=-1, attn_chunk=0)
    if cfg.arch_type == "encdec":
        kw["encoder_layers"] = L  # enc+dec scale together; full depths equal
    return dataclasses.replace(cfg, **kw)


def _config(arch: str, shape: str, overrides: Optional[Dict]) -> LMConfig:
    cfg = resolve_config(arch, shape)
    over = {k: v for k, v in (overrides or {}).items() if k not in ("param_mode", "cache_mode")}
    return dataclasses.replace(cfg, **over) if over else cfg


def _opt_state(params) -> AdamWState:
    """AdamW state like ``abstract_opt_state`` with the step a Python int,
    as a running trainer holds it."""
    opt = abstract_opt_state(params)
    return AdamWState(step=0, mu=opt.mu, nu=opt.nu)


def trace_step(cfg: LMConfig, shape: str, mesh, mapping, param_mode: str = "tp",
               cache_mode: str = "seq") -> LocalCost:
    """Run the step of ``shape``'s kind once on rank 0 of ``mesh`` (a fake
    process group), on meta ``DTensor``s placed by the rules, under
    :class:`LocalCost`.  The train step is loss, backward and AdamW; the
    prefill and serve steps end with their logits placed as ``repro``'s
    ``out_shardings`` (batch and vocab where the mesh's sizes divide them)."""
    specs = step_specs(cfg, shape)
    params = abstract_params(cfg)
    with bind_mesh(mesh, mapping, cache_mode=cache_mode), meta_reference():
        p = distribute(params, param_shardings(params, mesh, mapping, mode=param_mode))
        if specs["kind"] == "train":
            opt = _opt_state(params)
            o = distribute(opt, param_shardings(opt, mesh, mapping, mode=param_mode))
            b = distribute(specs["batch"], batch_shardings(specs["batch"], mesh, mapping))
            with LocalCost(mesh) as cost:
                make_train_step(cfg)(p, o, b)
        elif specs["kind"] == "prefill":
            b = distribute(specs["batch"], batch_shardings(specs["batch"], mesh, mapping))
            with LocalCost(mesh) as cost:
                logits, _ = make_prefill_step(cfg, capacity=SHAPES[shape]["seq_len"])(p, b)
                constrain(logits, "batch", "model")
        else:
            c = distribute(specs["cache"], cache_shardings(specs["cache"], mesh, mapping,
                                                           cache_mode))
            tok = specs["tokens"]
            t = distribute({"t": tok}, {"t": Sharding(mesh, _resolve(("batch",), mapping,
                                                                     tuple(tok.shape), mesh))})
            pos = SHAPES[shape]["seq_len"] - 1 if cfg.window > 0 else specs["capacity"] - 1
            with LocalCost(mesh) as cost:
                logits, _ = make_serve_step(cfg)(p, c, t["t"], pos)
                constrain(logits, "batch", "model")
    return cost


def cost_probe(arch: str, shape: str, mesh, mapping, overrides: Optional[Dict] = None) -> Dict:
    """Depth-corrected per-device cost: the step traced at two reduced
    depths (``_probe_depths``), every count extrapolated linearly in depth

        cost(L) = outside + L * per_layer,  per_layer = (c_b - c_a) / (L_b - L_a)

    (exact for every term linear in depth), plus the RWKV6 recurrence over
    rank 0's batch shard.  Returns the full-depth totals and the shallow
    probe's raw ones."""
    overrides = overrides or {}
    cfg0 = _config(arch, shape, overrides)
    La, Lb = _probe_depths(cfg0)
    costs = [trace_step(_probe_cfg(cfg0, L), shape, mesh, mapping,
                        overrides.get("param_mode", "tp"),
                        overrides.get("cache_mode", "seq")).totals() for L in (La, Lb)]
    out = {k: max(costs[0][k] + (cfg0.num_layers - La) * (costs[1][k] - costs[0][k]) / (Lb - La),
                  0.0) for k in costs[0]}
    if cfg0.arch_type == "rwkv":
        out["flops"] += recurrence_flops(cfg0, shape, _batch_shards(shape, mapping, mesh))
    return {"full": out, "raw": costs[0], "depths": (La, Lb)}


def _batch_shards(shape: str, mapping, mesh) -> int:
    B = SHAPES[shape]["batch"]
    sizes = lmesh.axis_sizes(mesh)
    axes = mapping["batch"] if isinstance(mapping["batch"], tuple) else (mapping["batch"],)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n if B % n == 0 else 1


def local_bytes(tree, shardings) -> int:
    """Rank 0's bytes of a tree of (meta) tensors under ``shardings``: each
    dim divided by the sizes of the mesh axes that shard it."""
    from repro_torch.launch.sharding import _flatten, _lookup

    sizes = lmesh.axis_sizes(next(iter(_flatten(shardings)))[1].mesh)
    total = 0
    for path, t in _flatten(tree):
        if not isinstance(t, torch.Tensor):
            continue
        n = t.numel()
        for axes in _lookup(shardings, path).spec:
            for a in (() if axes is None else axes if isinstance(axes, tuple) else (axes,)):
                n //= sizes[a]
        total += n * t.element_size()
    return total


def argument_bytes(arch: str, shape: str, mesh, mapping, overrides: Optional[Dict] = None
                   ) -> Dict[str, int]:
    """Rank 0's share of the full-depth step's arguments and outputs."""
    overrides = overrides or {}
    cfg = _config(arch, shape, overrides)
    pm, cm = overrides.get("param_mode", "tp"), overrides.get("cache_mode", "seq")
    specs = step_specs(cfg, shape)
    params = abstract_params(cfg)
    p = local_bytes(params, param_shardings(params, mesh, mapping, pm))
    meta = SHAPES[shape]
    B = meta["batch"]
    logits = torch.empty((B, cfg.vocab_size), dtype=cfg.act_dtype, device="meta")
    logit_bytes = local_bytes({"l": logits}, {"l": Sharding(mesh, _resolve(
        ("batch", "model"), mapping, tuple(logits.shape), mesh))})
    if specs["kind"] == "train":
        opt = abstract_opt_state(params)
        o = local_bytes(opt, param_shardings(opt, mesh, mapping, pm))
        b = local_bytes(specs["batch"], batch_shardings(specs["batch"], mesh, mapping))
        return {"argument": p + o + b, "output": p + o + 4}
    if specs["kind"] == "prefill":
        b = local_bytes(specs["batch"], batch_shardings(specs["batch"], mesh, mapping))
        cache = zero_cache(cfg, B, meta["seq_len"], "meta")
        c = local_bytes(cache, cache_shardings(cache, mesh, mapping, cm))
        return {"argument": p + b, "output": logit_bytes + c}
    c = local_bytes(specs["cache"], cache_shardings(specs["cache"], mesh, mapping, cm))
    tok = local_bytes({"t": specs["tokens"]}, {"t": Sharding(mesh, _resolve(
        ("batch",), mapping, tuple(specs["tokens"].shape), mesh))})
    return {"argument": p + c + tok + 8, "output": logit_bytes + c}


def dryrun_one(arch: str, shape: str, multi_pod: bool, mesh, save: bool = False,
               overrides: Optional[Dict] = None, tag_suffix: str = "") -> Dict:
    """One cell on ``mesh`` (the production mesh of ``multi_pod``, over a
    fake process group): ``repro``'s ``dryrun_one`` fields (see the module
    docstring for what differs)."""
    tag = f"{arch}_{shape}_{'multipod' if multi_pod else 'singlepod'}{tag_suffix}"
    mapping = lmesh.logical_axes(multi_pod=multi_pod)
    cfg = _config(arch, shape, overrides)
    t0 = time.time()
    probe = cost_probe(arch, shape, mesh, mapping, overrides)
    t_lower = time.time() - t0
    full, raw = probe["full"], probe["raw"]
    mem = argument_bytes(arch, shape, mesh, mapping, overrides)
    n_dev = mesh.size()
    model_s = full["axis:model"] / lmesh.NVLINK_BYTES_PER_S
    other_s = (full["coll"] - full["axis:model"]) / lmesh.INFINIBAND_BYTES_PER_S
    result = {
        "arch": arch,
        "shape": shape,
        "mesh": lmesh.mesh_label(mesh),
        "devices": n_dev,
        "lower_s": round(t_lower, 2),
        "compile_s": 0.0,
        "per_device": {
            "hlo_flops": full["flops"],
            "hlo_bytes": full["bytes"],
            "collective_bytes": full["coll"],
            "raw_uncorrected": {"hlo_flops": raw["flops"], "hlo_bytes": raw["bytes"],
                                "collective_bytes": raw["coll"], "depth": probe["depths"][0]},
            "depth_corrected": True,
            "probe_depths": list(probe["depths"]),
            "collectives": {**{c: full[f"coll:{c}"] for c in COLLECTIVES}, "total": full["coll"]},
            "collective_counts": {c: full[f"count:{c}"] for c in COLLECTIVES},
            "collectives_by_axis": {k[5:]: v for k, v in full.items() if k.startswith("axis:")},
        },
        "memory": {
            "argument_bytes": mem["argument"],
            "output_bytes": mem["output"],
            "temp_bytes": None,
            "generated_code_bytes": None,
            "fits_one_card": mem["argument"] <= H100_MEMORY_BYTES,
            "card_bytes": H100_MEMORY_BYTES,
        },
        "roofline": {
            "compute_s": full["flops"] / H100_BF16_FLOPS_PER_S,
            "memory_s": full["bytes"] / H100_HBM_BYTES_PER_S,
            "collective_s": model_s + other_s,
            "collective_model_s": model_s,
            "collective_other_s": other_s,
            "rates": {"flops": DATA_SHEET, "hbm": DATA_SHEET, **lmesh.LINK_SOURCES},
        },
        "model_flops_total": model_flops(cfg, shape),
    }
    r = result["roofline"]
    r["dominant"] = max(("compute_s", "memory_s", "collective_s"), key=lambda k: r[k])
    result["model_flops_ratio"] = (result["model_flops_total"] / (full["flops"] * n_dev)
                                   if full["flops"] else None)
    if save:
        os.makedirs(ARTIFACTS, exist_ok=True)
        with open(os.path.join(ARTIFACTS, tag + ".json"), "w") as f:
            json.dump(result, f, indent=2)
    return result


def init_fake_group(world: int = 512) -> None:
    """A fake process group of ``world`` ranks in this process, rank 0
    (collectives move nothing; shapes only).  Process-global: call it once,
    from an entry point."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _cell_command(args, arch: str, shape: str, mesh_name: str) -> List[str]:
    import sys

    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", mesh_name,
           "--arch", arch, "--shape", shape]
    if args.override:
        cmd += ["--override", args.override]
    if args.tag:
        cmd += ["--tag", args.tag]
    return cmd


def mesh_jobs(args, archs, shapes) -> List[Dict]:
    """``--mesh`` with ``--jobs N``: each cell in a subprocess of its own
    (each holds its own fake group), N at a time; the lines in cell order."""
    import subprocess
    from concurrent.futures import ThreadPoolExecutor

    meshes = {"single_pod": ["single_pod"], "multi_pod": ["multi_pod"],
              "both": ["single_pod", "multi_pod"]}[args.mesh]
    cells = [(a, s, m) for a in archs for s in shapes for m in meshes]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")

    def run(cell):
        return subprocess.run(_cell_command(args, *cell), capture_output=True, text=True, env=env)

    out, failures = [], []
    with ThreadPoolExecutor(args.jobs) as pool:
        for (arch, shape, m), proc in zip(cells, pool.map(run, cells)):
            lines = [x for x in proc.stdout.splitlines() if x.startswith("{")]
            if proc.returncode != 0 or not lines:
                failures.append((f"{arch}_{shape}_{m}", proc.stderr[-2000:]))
                print(f"[dryrun] FAIL {arch} {shape} {m}:\n{proc.stderr[-2000:]}", flush=True)
                continue
            out.append(json.loads(lines[-1]))
            print(lines[-1], flush=True)
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES:")
        for tag, _ in failures:
            print(" ", tag)
        raise SystemExit(1)
    print(f"[dryrun] all {len(out)} cells traced on the mesh", flush=True)
    return out


def mesh_main(args, archs, shapes) -> List[Dict]:
    """``--mesh``: every cell on the chosen meshes, a JSON line each;
    failures reported, then exit 1."""
    if args.jobs > 1:
        return mesh_jobs(args, archs, shapes)
    overrides = json.loads(args.override) if args.override else None
    meshes = {"single_pod": [False], "multi_pod": [True], "both": [False, True]}[args.mesh]
    init_fake_group(512 if True in meshes else 256)
    built = {mp: lmesh.make_production_mesh(multi_pod=mp, device_type="cpu") for mp in meshes}
    out, failures = [], []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}_{shape}_{'multipod' if mp else 'singlepod'}{args.tag}"
                try:
                    out.append(dryrun_one(arch, shape, mp, built[mp], save=bool(args.tag),
                                          overrides=overrides, tag_suffix=args.tag))
                    print(json.dumps(out[-1]), flush=True)
                except Exception as e:  # noqa: BLE001  (every failure is reported, then exit 1)
                    failures.append((tag, repr(e)))
                    print(f"[dryrun] FAIL {tag}: {e}", flush=True)
                    traceback.print_exc()
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES:")
        for tag, err in failures:
            print(" ", tag, err)
        raise SystemExit(1)
    print(f"[dryrun] all {len(out)} cells traced on the mesh", flush=True)
    return out


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    """The reports, each also printed as one JSON line."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="architecture id")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true", help="every architecture x shape")
    ap.add_argument("--mesh", default=None, choices=("single_pod", "multi_pod", "both"),
                    help="trace each step on the production mesh instead of the one-card report")
    ap.add_argument("--override", default=None,
                    help='JSON dict, e.g. \'{"param_mode": "fsdp", "cache_mode": "heads"}\' '
                         "(other keys replace config fields); with --mesh")
    ap.add_argument("--tag", default="", help="with --mesh: save each cell under "
                    "artifacts/torch_dryrun/, this suffix on the file name")
    ap.add_argument("--jobs", type=int, default=1,
                    help="with --mesh: cells traced in this many subprocesses at once")
    args = ap.parse_args(argv)
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("pass --arch and --shape, or --all")
    archs = ARCH_IDS if args.all else [args.arch]
    shapes = list(SHAPES) if args.all else [args.shape]
    if args.mesh:
        return mesh_main(args, archs, shapes)
    card = card_spec()
    out = []
    for arch in archs:
        for shape in shapes:
            out.append(report(arch, shape, card))
            print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    main()
