"""Open-loop chat traffic: Poisson arrivals at a fixed rate, prompts and
outputs of lognormal length, random token ids, no shared prefix.

Everything is drawn from the seed. The lengths and the inter-arrival gaps
are stratified draws: the k-th of n values is the distribution's quantile
at ``(k + u) / n`` with ``u`` uniform on [0, 1), and the three lists are
then shuffled apart. So each seed serves its own lengths and gaps, while
every seed's set follows the distribution closely and the seeds' totals
of work stay close: the spread between runs stays the system's, not the
draw's. The ``round(rate * seconds)`` arrivals are spread over the window
(the gaps scaled to end inside it), so every run attempts the same number
of requests.

Parameters: ``rate`` (requests/s), ``prompt`` and ``output`` (``median``,
``sigma``, ``lo``, ``hi``).
"""
from __future__ import annotations

import statistics

import numpy as np

MODE = "open_loop"
_NORMAL = statistics.NormalDist()


def strata(rng, n: int) -> np.ndarray:
    """One uniform draw in each of n equal strata of [0, 1), in a random order."""
    return rng.permutation((np.arange(n) + rng.random(n)) / n)


def lognormal(u: np.ndarray, median: float, sigma: float, lo: int, hi: int) -> np.ndarray:
    """The lognormal's quantiles at ``u``, rounded and clipped to [lo, hi]."""
    z = np.array([_NORMAL.inv_cdf(min(max(x, 1e-12), 1 - 1e-12)) for x in u])
    return np.clip(np.round(median * np.exp(sigma * z)), lo, hi).astype(np.int64)


def generate(p: dict, seed: int, seconds: float, vocab: int) -> list:
    """[(due s from the window's start, prompt token ids, output tokens)] in
    due order."""
    n = max(1, round(p["rate"] * seconds))
    rng = np.random.default_rng([seed % 2 ** 64, 1])
    prompts = lognormal(strata(rng, n), **p["prompt"])
    outs = lognormal(strata(rng, n), **p["output"])
    gaps = -np.log1p(-strata(rng, n + 1))          # unit exponential quantiles
    due = seconds * np.cumsum(gaps)[:-1] / gaps.sum()
    return [(float(due[j]), rng.integers(1, vocab, size=int(prompts[j])).tolist(),
             int(outs[j])) for j in range(n)]


def warmup(p: dict, seed: int, vocab: int) -> list:
    """Prompts at the shortest, median and longest prompt length."""
    rng = np.random.default_rng([seed % 2 ** 64, 2])
    q = p["prompt"]
    return [rng.integers(1, vocab, size=n).tolist()
            for n in (q["lo"], int(q["median"]), q["hi"])]
