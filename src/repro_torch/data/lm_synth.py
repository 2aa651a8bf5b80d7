"""Synthetic LM token streams for smoke tests and end-to-end runs (a copy of
``repro.data.lm_synth``, numpy only).

Markov-chain token synthesis with a power-law unigram prior — enough
structure that a ~100M model's loss visibly decreases over a few hundred
steps, while remaining fully offline and deterministic.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def synth_lm_batch(
    rng: np.random.Generator,
    batch: int,
    seq_len: int,
    vocab: int,
    order: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (tokens, labels) each (batch, seq_len) int32; labels are
    tokens shifted left with -1 padding in the last position."""
    # power-law unigram over an effective sub-vocabulary for structure
    eff = min(vocab, 4096)
    ranks = np.arange(1, eff + 1, dtype=np.float64)
    probs = 1.0 / ranks**1.1
    probs /= probs.sum()
    toks = rng.choice(eff, size=(batch, seq_len), p=probs).astype(np.int64)
    # inject local structure: with prob 0.5 copy previous token + fixed offset
    copy = rng.uniform(size=(batch, seq_len)) < 0.5
    for t in range(1, seq_len):
        toks[:, t] = np.where(
            copy[:, t], (toks[:, t - 1] * 31 + 7) % eff, toks[:, t]
        )
    labels = np.full_like(toks, -1)
    labels[:, :-1] = toks[:, 1:]
    return toks.astype(np.int32), labels.astype(np.int32)
