"""The ``gloo`` worker of ``test_torch_mesh_gloo.py``: eight processes, two
meshes of four ranks that run side by side (ranks 0-3 the (1, 4) mesh,
4-7 the (2, 2) one).  Every rank builds the same seeded float32 parameters
and batches of reduced configs, runs each step unbound (the reference) and
under its bound mesh, gathers the replicated loss and one replicated AdamW
leaf from the mesh's four ranks, and the first rank of each mesh writes
what it compared to a JSON file.  Imports no JAX."""
from __future__ import annotations

import datetime
import json
import os
from typing import Dict

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.launch.meshctx import bind_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm
from repro_torch.train.adamw import adamw_init
from repro_torch.tree import tree_leaves

ARCHS = ("qwen2_7b", "deepseek_moe_16b", "rwkv6_1b6", "whisper_base")
MESHES = ((1, 4), (2, 2))
B, S, STEPS = 4, 16, 8


def config(arch: str):
    """The reduced config (float32, 2 layers); qwen2-7b keeps its
    ``attn_seq_shard``."""
    return lm.reduced(get_config(arch))


def batch_of(cfg, seed: int = 0) -> Dict[str, torch.Tensor]:
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    if cfg.arch_type == "encdec":
        batch["audio_frames"] = torch.randn(B, cfg.encoder_frames, cfg.d_model, generator=g)
    return batch


def rel_err(got, want) -> float:
    """max |got - want| / max |want| (got gathered if it is a DTensor)."""
    got = got.full_tensor() if hasattr(got, "full_tensor") else got
    return float((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30))


def greedy(params, cfg, batch, mode=None):
    """8 greedy tokens a row after a prefill of the batch's tokens."""
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    logits, cache = lm.prefill(params, cfg, prompt, capacity=S + STEPS)
    placements = {k: [str(p) for p in v.placements] for k, v in cache.items()} if mode else None
    out = []
    for t in range(STEPS):
        logits = logits.full_tensor() if hasattr(logits, "full_tensor") else logits
        tok = logits.argmax(-1)
        out.append(tok.tolist())
        logits, cache = lm.decode_step(params, cfg, cache, tok, S + t)
    return out, placements


def ranks_equal(value, group) -> bool:
    """Whether every rank of ``group`` holds the same bits of a replicated
    ``DTensor``'s local value."""
    local = value.to_local().contiguous()
    gathered = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
    dist.all_gather(gathered, local, group=group)
    return all(torch.equal(g, gathered[0]) for g in gathered)


def run_case(arch: str, shape, mesh_obj, mapping, group) -> Dict:
    cfg = config(arch)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu", dtype=torch.float32)
    batch = batch_of(cfg)
    step = make_train_step(cfg)
    res: Dict = {}
    # the unbound reference
    logits_ref, _ = lm.forward(params, cfg, batch)
    _, opt_ref, loss_ref = step(params, adamw_init(params), batch)
    tokens_ref, _ = greedy(params, cfg, batch)
    with bind_mesh(mesh_obj, mapping):
        p = tsh.distribute(params, tsh.param_shardings(params, mesh_obj, mapping))
        b = tsh.distribute(batch, tsh.batch_shardings(batch, mesh_obj, mapping))
        logits, _ = lm.forward(p, cfg, b)
        res["forward"] = rel_err(logits, logits_ref)
        res["logits_placements"] = [str(x) for x in logits.placements]
        opt = adamw_init(params)
        o = tsh.distribute(opt, tsh.param_shardings(opt, mesh_obj, mapping))
        _, o1, loss = step(p, o, b)
        res["loss"] = rel_err(loss, loss_ref)
        res["loss_placements"] = [str(x) for x in loss.placements]
        # after one step mu = (1 - b1) * clipped gradient: the gradients' hold
        res["grads"] = max(rel_err(g, w) for g, w in zip(tree_leaves(o1.mu), tree_leaves(opt_ref.mu)))
        res["grads_are_dtensors"] = all(hasattr(g, "placements") for g in tree_leaves(o1.mu))
        # the replicated loss and a replicated AdamW leaf: the same bits on every rank
        res["loss_ranks_equal"] = ranks_equal(loss, group)
        mu = next(g for g in tree_leaves(o1.mu) if all(x.is_replicate() for x in g.placements))
        res["mu_ranks_equal"] = ranks_equal(mu, group)
    for mode in tsh.CACHE_MODES:
        with bind_mesh(mesh_obj, mapping, cache_mode=mode):
            toks, placements = greedy(p, cfg, b, mode)
        want = tsh.cache_shardings(lm.zero_cache(cfg, B, S + STEPS, "meta"), mesh_obj, mapping, mode)
        res[f"decode_{mode}"] = {
            "equal": toks == tokens_ref,
            "placements_match": placements == {k: [str(x) for x in v.placements()]
                                               for k, v in want.items()},
        }
    return res


WORLD = 4 * len(MESHES)


def worker(rank: int, store: str, out: str) -> None:
    """Rank ``rank`` of ``WORLD``; writes ``out``.<mesh index> from the first
    rank of each mesh."""
    from torch.distributed.device_mesh import DeviceMesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    try:
        # every rank makes every mesh (subgroups are made collectively)
        meshes = [DeviceMesh("cpu", torch.arange(4 * i, 4 * i + 4).reshape(shape),
                             mesh_dim_names=("data", "model")) for i, shape in enumerate(MESHES)]
        groups = [dist.new_group(list(range(4 * i, 4 * i + 4))) for i in range(len(MESHES))]
        i = rank // 4
        shape, mesh_obj, mapping = MESHES[i], meshes[i], tmesh.logical_axes()
        results = {}
        for arch in ARCHS:
            key = f"{arch}@{shape[0]}x{shape[1]}"
            try:
                results[key] = run_case(arch, shape, mesh_obj, mapping, groups[i])
            except Exception as e:  # noqa: BLE001  (reported per case by the test)
                results[key] = {"error": f"{type(e).__name__}: {e}"}
        if rank % 4 == 0:
            with open(f"{out}.{i}.tmp", "w") as f:
                json.dump(results, f)
            os.replace(f"{out}.{i}.tmp", f"{out}.{i}")
        dist.barrier()
    finally:
        dist.destroy_process_group()
