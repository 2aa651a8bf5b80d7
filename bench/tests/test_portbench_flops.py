"""The copied and corrected arithmetic against counts by hand."""
import json

import pytest

from portbench_util import BENCH

from harness import flops


def test_bound_takes_the_larger():
    assert flops.bound_s(3.35e12, 0.0, 1.0) == (1.0, "bytes")
    assert flops.bound_s(0.0, 989e12 * 2, flops.PEAK_BF16_OPS_PER_S) == (2.0, "operations")


def test_flash_sdpa_cost_by_hand():
    # B 1, S = T 4, H 2, K 1, D 8, causal: 1 * 2 * (4 * 5 / 2) = 20 pairs
    b, ops, peak = flops.flash_sdpa_cost(1, 4, 4, 2, 1, 8)
    assert ops == 4 * 8 * 20
    assert b == 2 * (2 * 1 * 4 * 2 * 8 + 2 * 1 * 4 * 1 * 8)
    assert peak == flops.PEAK_BF16_OPS_PER_S
    # the chip smoke test's prefill record: 8 x 512, 28 / 4 heads, D 128
    b, ops, _ = flops.flash_sdpa_cost(8, 512, 512, 28, 4, 128)
    assert ops == 4 * 128 * 8 * 28 * 512 * 513 // 2
    assert round(flops.bound_s(b, ops, flops.PEAK_BF16_OPS_PER_S)[0] * 1e3, 4) == 0.0200
    # non-causal: every key
    assert flops.flash_sdpa_cost(1, 3, 5, 1, 1, 8, causal=False)[1] == 4 * 8 * 15


def test_wkv6_cost_by_hand():
    b, ops, peak = flops.wkv6_cost(1, 2, 1, 4, 4)
    n = 2
    assert ops == 5 * n * 16 + n * (3 * 4 + 2 * 4)
    assert b == n * 4 * 8 + n * 4 * 2 + 4 * 4 + 2 * 16 * 4 + n * 4 * 4
    assert peak == flops.PEAK_F32_OPS_PER_S
    # the chip smoke test's prefill bound, 8 x 512, 32 heads, K = V = 64
    b, ops, peak = flops.wkv6_cost(8, 512, 32, 64, 64)
    assert round(flops.bound_s(b, ops, peak)[0] * 1e3, 4) == 0.0407


def test_dense_model_flops_by_hand():
    m = {"arch_type": "dense", "d_model": 4, "num_heads": 2, "num_kv_heads": 1, "head_dim": 2,
         "d_ff": 6, "vocab_size": 10, "num_layers": 3}
    per_layer_weights = 4 * 4 + 4 * 2 + 4 * 2 + 4 * 4 + 3 * 4 * 6  # q, k, v, o, gate/up/down
    n = 5
    want = 3 * (2 * per_layer_weights * n + 4 * 2 * 2 * (n * (n + 1) // 2)) + 2 * 4 * 10 * n
    assert flops.model_flops_per_sequence(m, 3, n) == want
    assert flops.cascade_flops(m, 1, [n, 2]) == sum(
        flops.model_flops_per_sequence(m, 1, k) + flops.model_flops_per_sequence(m, 3, k)
        for k in (n, 2))


def test_rwkv_model_flops_by_hand():
    m = {"arch_type": "rwkv", "d_model": 8, "rwkv_head_size": 4, "d_ff": 16, "vocab_size": 10,
         "num_layers": 2}
    r = 32
    # token-shift LoRA A (M, 5r) and B as published, five (r, M) blocks; the
    # decay LoRA (M, 2r), (2r, M); r / k / v / g / o; the channel mix
    weights = 8 * 5 * r + 5 * r * 8 + 8 * 2 * r + 2 * r * 8 + 5 * 64 + 2 * 8 * 16 + 64
    n = 3
    want = 2 * (2 * weights * n + 8 * 8 * 4 * n) + 2 * 8 * 10 * n
    assert flops.model_flops_per_sequence(m, 2, n) == want


@pytest.mark.parametrize("arch", ["moe", "hybrid"])
def test_a_family_without_a_count_gives_none(arch):
    """A cell of another family can be added from files alone: its mfu
    reader then reads nothing, and nothing raises."""
    m = {"arch_type": arch, "d_model": 8, "vocab_size": 10, "num_layers": 2}
    assert flops.model_flops_per_sequence(m, 2, 3) is None
    assert flops.cascade_flops(m, 1, [3, 4]) is None


@pytest.mark.parametrize("name", ["qwen2-7b", "rwkv6-1.6b"])
def test_full_size_counts_are_plausible(name):
    """A scored token of the full model costs about twice its parameters
    (less the embedding table), plus attention or recurrence."""
    conf = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    m = conf["model"]
    per_token = flops.model_flops_per_sequence(m, m["num_layers"], 1)
    params = {"qwen2-7b": 7.07e9, "rwkv6-1.6b": 1.5e9}[name]
    assert 0.9 < per_token / (2 * params) < 1.15
