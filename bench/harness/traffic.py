"""The one traffic generator: closed-loop batches of scored prompts, driven
by a mix file (``bench/traffic/<mix>.json``).

Tokens come from ``synth_lm_batch``, a copy of the port's
``data/lm_synth.py`` (Markov-chain tokens under a power-law unigram prior,
numpy only).  The sizes come from a *layout*: a block of ``block_batches``
batches of ``batch`` prompts each, drawn once from the mix's
``layout_seed``.  Prompt lengths follow the mix's ``lengths`` section,
``{"dist": "lognormal", "median": m, "sigma": s, "min": a, "max": b}``:
exp(N(ln m, s^2)), rounded down, kept only inside [a, b] (the distribution
conditioned on the cell's band of lengths, by rejection).  So every run
seed serves the same set of sizes, and only their order and the tokens
change with the seed: a block is the same work in another order, and the
seed cannot change how much work a window holds.

Within a batch each prompt is padded on the right with token 0 to the
batch's longest prompt, rounded up to ``pad_multiple``; its labels are the
next token at each position but the prompt's last, and -1 there and on the
padding, so only real next-token positions are scored.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np


def synth_lm_batch(rng: np.random.Generator, batch: int, seq_len: int, vocab: int,
                   zipf_vocab: int = 4096, zipf_power: float = 1.1,
                   copy_prob: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
    """(tokens, labels), each (batch, seq_len) int32; labels are the tokens
    shifted left with -1 in the last position.  A power-law unigram over
    the first ``zipf_vocab`` ids, and with probability ``copy_prob`` a
    position copies the previous token times 31 plus 7 (mod the sub-vocabulary)
    instead.  With the defaults the draws are those of
    ``repro_torch.data.lm_synth.synth_lm_batch`` for the same generator."""
    eff = min(vocab, zipf_vocab)
    ranks = np.arange(1, eff + 1, dtype=np.float64)
    probs = 1.0 / ranks**zipf_power
    probs /= probs.sum()
    toks = rng.choice(eff, size=(batch, seq_len), p=probs).astype(np.int64)
    copy = rng.uniform(size=(batch, seq_len)) < copy_prob
    for t in range(1, seq_len):
        toks[:, t] = np.where(copy[:, t], (toks[:, t - 1] * 31 + 7) % eff, toks[:, t])
    labels = np.full_like(toks, -1)
    labels[:, :-1] = toks[:, 1:]
    return toks.astype(np.int32), labels.astype(np.int32)


@dataclass(frozen=True)
class Mix:
    """A traffic mix file's parameters (``driver`` names the module under
    ``bench/drivers/`` that serves it)."""

    driver: str
    batch: int
    lengths: Dict
    pad_multiple: int
    block_batches: int
    pool_blocks: int
    layout_seed: int
    calibration_blocks: int
    ratio: float
    tokens: Dict

    @classmethod
    def from_file(cls, spec: Dict) -> "Mix":
        return cls(**{k: spec[k] for k in cls.__dataclass_fields__})

    @property
    def min_len(self) -> int:
        return int(self.lengths["min"])

    @property
    def max_len(self) -> int:
        return int(self.lengths["max"])


def padded_len(lengths, multiple: int) -> int:
    return int(-(-max(lengths) // multiple) * multiple)


def draw_lengths(rng: np.random.Generator, spec: Dict, n: int) -> np.ndarray:
    """``n`` prompt lengths from a ``lengths`` section (see the module's
    docstring)."""
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] != "lognormal":
        raise ValueError(f"no length distribution {spec['dist']!r}")
    out = np.empty(0, np.int64)
    while out.size < n:
        x = np.floor(np.exp(rng.normal(np.log(spec["median"]), spec["sigma"], size=4 * n)))
        out = np.concatenate([out, x[(x >= lo) & (x <= hi)].astype(np.int64)])
    return out[:n]


def layout(mix: Mix) -> List[Tuple[int, ...]]:
    """The block's batches, each a tuple of prompt lengths (seed-free)."""
    rng = np.random.default_rng(mix.layout_seed)
    lens = draw_lengths(rng, mix.lengths, mix.block_batches * mix.batch)
    return [tuple(int(n) for n in row) for row in lens.reshape(mix.block_batches, mix.batch)]


def shapes(mix: Mix) -> List[int]:
    """The padded lengths the layout uses, ascending: the shapes to warm."""
    return sorted({padded_len(b, mix.pad_multiple) for b in layout(mix)})


def padding_share(mix: Mix) -> float:
    """The share of the layout's computed positions that are padding."""
    real = sum(sum(b) for b in layout(mix))
    return 1.0 - real / sum(mix.batch * padded_len(b, mix.pad_multiple) for b in layout(mix))


def make_batch(rows: List[np.ndarray], lengths, multiple: int) -> Dict:
    """One padded batch from token rows cut to ``lengths``."""
    P = padded_len(lengths, multiple)
    toks = np.zeros((len(lengths), P), np.int32)
    labels = np.full((len(lengths), P), -1, np.int32)
    for i, (row, n) in enumerate(zip(rows, lengths)):
        toks[i, :n] = row[:n]
        labels[i, :n - 1] = row[1:n]
    return {"tokens": toks, "labels": labels, "lengths": tuple(int(n) for n in lengths), "pad": P}


def _draw(rng: np.random.Generator, batches: List[Tuple[int, ...]], vocab: int, mix: Mix):
    """Tokens for ``batches`` (tuples of lengths), in one vectorized draw."""
    n = sum(len(b) for b in batches)
    longest = max(max(b) for b in batches)
    toks, _ = synth_lm_batch(rng, n, longest, vocab, **mix.tokens)
    out, i = [], 0
    for lengths in batches:
        out.append(make_batch(list(toks[i:i + len(lengths)]), lengths, mix.pad_multiple))
        i += len(lengths)
    return out


def window_batches(mix: Mix, vocab: int, seed: int) -> List[Dict]:
    """The run's pool: ``pool_blocks`` blocks, each the layout's batches in
    an order drawn from ``seed``, with each batch's rows in an order drawn
    from it, and fresh tokens.  A window serves them in turn and starts
    over when it runs out."""
    rng = np.random.default_rng([seed, 0])
    base = layout(mix)
    order = []
    for _ in range(mix.pool_blocks):
        for j in rng.permutation(len(base)):
            order.append(tuple(base[j][i] for i in rng.permutation(mix.batch)))
    return _draw(rng, order, vocab, mix)


def calibration_batches(mix: Mix, vocab: int, seed: int) -> List[Dict]:
    """``calibration_blocks`` blocks of the layout's batches, in layout
    order, with tokens from a stream of ``seed`` the window does not use:
    the set-up runs them to calibrate the decision stack, on the window's
    own mix of lengths."""
    rng = np.random.default_rng([seed, 1])
    return _draw(rng, layout(mix) * mix.calibration_blocks, vocab, mix)


def warm_batches(cal: List[Dict]) -> List[Dict]:
    """The first calibration batch of each padded shape: serving them warms
    every shape the window uses."""
    first: Dict[int, Dict] = {}
    for b in cal:
        first.setdefault(b["pad"], b)
    return [first[p] for p in sorted(first)]


def sample_batches(count: int, served: List[Dict], seed: int) -> List[int]:
    """Indices of the ``count`` served batches whose answers are checked:
    the first batch that holds the longest prompt served, and the rest
    drawn from ``seed``."""
    longest = max(range(len(served)), key=lambda i: max(served[i]["lengths"]))
    rest = [i for i in range(len(served)) if i != longest]
    rng = np.random.default_rng([seed, 2])
    k = min(count - 1, len(rest))
    picked = rng.choice(len(rest), size=k, replace=False) if k else []
    return [longest] + sorted(rest[int(j)] for j in picked)
