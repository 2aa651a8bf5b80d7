"""The seeded traffic: the copy of the port's token generator, the layout,
padding, and determinism."""
import json
from collections import Counter

import numpy as np
import pytest

from portbench_util import BENCH

from harness import traffic as tr

MIXES = {p.stem: tr.Mix.from_file(json.loads(p.read_text()))
         for p in (BENCH / "traffic").glob("*.json")}
SEED = 3_000_000_019  # past 32 signed bits


def test_generator_is_the_ports():
    from repro_torch.data.lm_synth import synth_lm_batch

    a = synth_lm_batch(np.random.default_rng(7), 3, 50, 1000)
    b = tr.synth_lm_batch(np.random.default_rng(7), 3, 50, 1000)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", sorted(MIXES))
def test_pool_is_deterministic_and_padded(name):
    mix = MIXES[name]
    pool = tr.window_batches(mix, 1000, SEED)
    again = tr.window_batches(mix, 1000, SEED)
    assert len(pool) == mix.block_batches * mix.pool_blocks
    for b, c in zip(pool, again):
        np.testing.assert_array_equal(b["tokens"], c["tokens"])
        np.testing.assert_array_equal(b["labels"], c["labels"])
    for b in pool[:20]:
        P = b["pad"]
        assert P % mix.pad_multiple == 0 and P >= max(b["lengths"]) > P - mix.pad_multiple
        assert b["tokens"].shape == b["labels"].shape == (mix.batch, P)
        for i, n in enumerate(b["lengths"]):
            assert mix.min_len <= n <= mix.max_len
            assert (b["tokens"][i, n:] == 0).all()
            assert (b["labels"][i, n - 1:] == -1).all()
            np.testing.assert_array_equal(b["labels"][i, :n - 1], b["tokens"][i, 1:n])
            assert (b["labels"][i, :n - 1] >= 0).all()


@pytest.mark.parametrize("name", sorted(MIXES))
def test_every_seed_serves_the_same_work(name):
    """Each block holds the layout's batches: only order and tokens follow
    the seed."""
    mix = MIXES[name]
    want = Counter(tuple(sorted(b)) for b in tr.layout(mix))
    for seed in (1, SEED):
        pool = tr.window_batches(mix, 1000, seed)
        for k in range(mix.pool_blocks):
            block = pool[k * mix.block_batches:(k + 1) * mix.block_batches]
            assert Counter(tuple(sorted(b["lengths"])) for b in block) == want
    a = tr.window_batches(mix, 1000, 1)[0]["tokens"]
    b = tr.window_batches(mix, 1000, 2)[0]["tokens"]
    assert a.shape != b.shape or not np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(MIXES))
def test_calibration_is_a_block_of_the_window_and_warms_every_shape(name):
    mix = MIXES[name]
    cal = tr.calibration_batches(mix, 1000, SEED)
    assert [b["lengths"] for b in cal] == tr.layout(mix) * mix.calibration_blocks
    assert [b["pad"] for b in tr.warm_batches(cal)] == tr.shapes(mix)


@pytest.mark.parametrize("name", sorted(MIXES))
def test_lengths_follow_the_mix_distribution(name):
    """The layout's lengths lie in the band, and a large draw of the same
    distribution has the conditioned lognormal's median within the band."""
    mix = MIXES[name]
    spec = mix.lengths
    lens = tr.draw_lengths(np.random.default_rng(0), spec, 20000)
    assert lens.min() >= spec["min"] and lens.max() <= spec["max"]
    from statistics import NormalDist

    d = NormalDist(np.log(spec["median"]), spec["sigma"])
    lo, hi = d.cdf(np.log(spec["min"])), d.cdf(np.log(spec["max"] + 1))
    want = np.exp(d.inv_cdf((lo + hi) / 2))
    assert abs(np.median(lens) - want) / want < 0.02
    assert 0.0 < tr.padding_share(mix) < 0.6


def test_sample_holds_the_longest():
    mix = MIXES["score-long"]
    pool = tr.window_batches(mix, 1000, SEED)[:10]
    idx = tr.sample_batches(3, pool, SEED)
    assert len(idx) == 3 == len(set(idx))
    assert max(pool[idx[0]]["lengths"]) == max(max(b["lengths"]) for b in pool)
    assert idx == tr.sample_batches(3, pool, SEED)
