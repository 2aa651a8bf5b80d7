"""The sharded step against the unbound port, on CPU processes over
``gloo`` (one spawn for the module: eight ranks, two meshes of four side
by side): reduced dense (qwen2-7b, with
``attn_seq_shard``: context-parallel attention), MoE (deepseek-moe-16b),
RWKV6 (rwkv6-1.6b) and encoder-decoder (whisper-base) configs in float32,
on the meshes (1, 4) and (2, 2) of ``("data", "model")``, parameters and
batch distributed by ``launch.sharding``'s rules (``tp``).

Held: the forward's logits, and the train step's loss and gradients (its
AdamW ``mu`` after one step: 0.1 x the clipped gradient), each within 1e-5 of the largest value of the unbound result
(tensor parallelism sums partial products in another order), the loss
replicated and the same bits on every rank of the mesh (as is one
replicated AdamW ``mu`` leaf); 8 greedy decode tokens a row equal to the unbound ones on each
of the four cache modes, the cache placed as ``cache_shardings`` says; the
logits ``DTensor``s placed by ``constrain`` (batch over ``data``, vocab
over ``model``)."""
import json
import os
import tempfile

import pytest
import torch.multiprocessing as mp

import _torch_mesh_worker as W

TOL = 1e-5
CASES = [(a, f"{m[0]}x{m[1]}") for m in W.MESHES for a in W.ARCHS]


@pytest.fixture(scope="module")
def results():
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "results.json")
        mp.spawn(W.worker, args=(os.path.join(tmp, "store"), out), nprocs=W.WORLD, join=True)
        merged = {}
        for i in range(len(W.MESHES)):
            with open(f"{out}.{i}") as f:
                merged.update(json.load(f))
        return merged


def case(results, arch, mesh):
    res = results[f"{arch}@{mesh}"]
    assert "error" not in res, res.get("error")
    return res


@pytest.mark.parametrize("arch,mesh", CASES)
def test_sharded_forward_matches_unbound(results, arch, mesh):
    res = case(results, arch, mesh)
    assert res["forward"] <= TOL
    assert res["logits_placements"] == ["S(0)", "S(2)"]  # batch 4 over data, vocab 512 over model


@pytest.mark.parametrize("arch,mesh", CASES)
def test_sharded_loss_and_gradients_match_unbound(results, arch, mesh):
    res = case(results, arch, mesh)
    assert res["loss"] <= TOL and res["grads"] <= TOL
    assert res["grads_are_dtensors"]
    assert res["loss_placements"] == ["R", "R"]


@pytest.mark.parametrize("arch,mesh", CASES)
def test_replicated_values_bit_equal_across_ranks(results, arch, mesh):
    """``DTensor`` warns that redistributing the loss (Partial, Partial) ->
    Replicate over two mesh dims "may give inconsistent results between
    ranks"; the loss and a replicated AdamW ``mu`` leaf after the step hold
    the same bits on every rank of the mesh."""
    res = case(results, arch, mesh)
    assert res["loss_ranks_equal"] and res["mu_ranks_equal"]


@pytest.mark.parametrize("mode", ["seq", "heads", "batch", "headdim"])
@pytest.mark.parametrize("arch,mesh", CASES)
def test_sharded_greedy_decode_matches_unbound(results, arch, mesh, mode):
    res = case(results, arch, mesh)[f"decode_{mode}"]
    assert res["equal"]
    assert res["placements_match"]
