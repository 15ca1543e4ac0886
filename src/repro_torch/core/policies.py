"""Paper §3.3.1/§3.3.2 policies: GClock scoring, flush scores, clean-first eviction.

Pure-numpy reference implementations. These are the oracle for the JAX twin in
``sa_cache.py`` and the policy engine of the discrete-event simulator
(``gc_sim.py`` / ``safs_sim.py``).

Terminology (paper §3.3.1):
    distance_score = hits * set_size + distance
where ``distance`` is the forward distance from the GClock hand to the page's
slot. Pages are ranked ascending by distance score; the rank (0 = smallest
distance score = closest to eviction) maps to the *highest* flush score:
    flush_score = set_size - 1 - rank.
"""
from __future__ import annotations

import numpy as np

# Paper defaults (§3.2, §3.3).
SET_SIZE = 12            # pages per set                      [paper: 12]
FLUSH_TRIGGER = 6        # dirty pages in a set that trigger the flusher
FLUSHES_PER_VISIT = 2    # "one or two" pages flushed per set visit
RESERVED_SLOTS = 7       # device slots reserved for high-priority I/O
DEVICE_SLOTS = 32        # parallel requests an SSD wants for max performance
MAX_PENDING_FLUSH_PER_DEV = 2048  # global flush cap = 2048 x n_devices


def gclock_distance(positions: np.ndarray, clock_hand: int, set_size: int) -> np.ndarray:
    """Forward distance from the clock hand to each slot position."""
    return (positions - clock_hand) % set_size


def distance_scores(hits: np.ndarray, clock_hand: int, set_size: int | None = None) -> np.ndarray:
    """Paper: distance_score = hits * set_size + distance (per slot)."""
    if set_size is None:
        set_size = int(hits.shape[-1])
    pos = np.arange(set_size)
    return hits.astype(np.int64) * set_size + gclock_distance(pos, clock_hand, set_size)


def flush_scores(hits: np.ndarray, clock_hand: int, valid: np.ndarray | None = None) -> np.ndarray:
    """Rank-based flush score: lower distance score -> higher flush score.

    ``valid`` masks slots that hold pages; invalid slots get flush score -1.
    Ties broken by slot index (stable argsort) to match the JAX twin exactly.
    """
    set_size = int(hits.shape[-1])
    d = distance_scores(hits, clock_hand, set_size)
    if valid is not None:
        d = np.where(valid, d, np.iinfo(np.int64).max)
    order = np.argsort(d, kind="stable")          # ascending distance score
    rank = np.empty(set_size, dtype=np.int64)
    rank[order] = np.arange(set_size)
    fs = set_size - 1 - rank
    if valid is not None:
        fs = np.where(valid, fs, -1)
    return fs


def gclock_evict(
    hits: np.ndarray,
    clock_hand: int,
    valid: np.ndarray,
    dirty: np.ndarray | None = None,
    clean_first: bool = True,
) -> tuple[int, np.ndarray, int]:
    """GClock victim selection with optional clean-first preference (§3.3).

    Sweeps from the clock hand decrementing hit counts; the first page with
    hits == 0 is the victim. With ``clean_first`` the sweep considers only
    clean pages on the first lap over candidates; if every candidate is dirty
    the sweep falls back to all pages (the application write must then wait on
    the dirty writeback — the case the flusher makes rare).

    Returns (victim_slot, new_hits, new_clock_hand). Invalid (empty) slots are
    claimed immediately without a sweep.
    """
    set_size = int(hits.shape[-1])
    empty = np.flatnonzero(~valid)
    if empty.size:
        return int(empty[0]), hits.copy(), clock_hand

    def sweep(eligible: np.ndarray):
        h = hits.copy()
        hand = clock_hand
        # Each full lap decrements every eligible page once; max hits bounds laps.
        for _ in range(set_size * (int(h.max(initial=0)) + 2)):
            if eligible[hand]:
                if h[hand] == 0:
                    return hand, h, (hand + 1) % set_size
                h[hand] -= 1
            hand = (hand + 1) % set_size
        return None  # pragma: no cover - unreachable: some page reaches 0

    if clean_first and dirty is not None:
        clean = valid & ~dirty
        if clean.any():
            res = sweep(clean)
            if res is not None:
                return res
    res = sweep(valid)
    assert res is not None
    return res


def is_stale(
    *,
    evicted: bool,
    cleaned: bool,
    current_flush_score: int,
    score_threshold: int,
) -> bool:
    """Paper §3.3.2: discard a queued flush request iff the page was evicted,
    was re-cleaned, or its *current* flush score dropped below the threshold."""
    return evicted or cleaned or current_flush_score < score_threshold
