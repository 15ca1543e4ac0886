"""Training batches: a frozen copy of the port's ``SyntheticLM`` stream
(Zipf ranks over the vocabulary, a quarter of the tokens a function of
the one before), sequences packed end to end with no document mask; the
labels are the tokens shifted by one. Step k of seed n is always the same
batch, and no two steps share rows.

Parameters: ``batch`` (rows a step), ``seq``, ``zipf_s``, ``prev_share``.
"""
from __future__ import annotations

import numpy as np

MODE = "train"


def batch(p: dict, seed: int, step: int, vocab: int) -> dict:
    rng = np.random.default_rng(((seed % 2 ** 63) << 20) ^ step)
    b, s = p["batch"], p["seq"]
    ranks = rng.zipf(p["zipf_s"], size=(b, s + 1)) % vocab
    shift = (ranks[:, :-1] * 31 + 7) % vocab
    use_prev = rng.random((b, s)) < p["prev_share"]
    seq = ranks[:, 1:].copy()
    seq[use_prev] = shift[use_prev]
    tokens = np.concatenate([ranks[:, :1], seq], axis=1).astype(np.int64)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
