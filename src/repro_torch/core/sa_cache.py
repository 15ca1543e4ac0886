"""Set-associative cache (SA-cache, paper section 3.1) as a PyTorch state
machine: the twin of ``repro/core/sa_cache.py``, name for name.

Every policy decision is an elementwise or argmin computation over a
``(num_sets, set_size)`` tensor, so one call scores all sets at once. The
key identity (paper section 3.3.1): a GClock sweep from the hand visits slot
``p`` (forward distance ``d``) with hit count ``h`` and evicts it at sweep
time ``h * set_size + d``, the distance score. So the sweep victim is the
argmin of the distance score over the eligible slots, and eviction is
analytic instead of a loop.

The ops keep JAX's ``state -> state`` contract: each returns a new
:class:`CacheState` and leaves the one it was given as it was (the tensors
it changes are copied first; the others are shared). The all-sets flush
scoring goes through ``kernels.ops.flush_scores``: the Hopper kernel for a
state on the card, its plain version for one on the CPU.

Indices (``set_idx``, ``slot``, ``tag``) may be Python ints or 0-d tensors;
results that JAX returns as 0-d arrays come back as 0-d tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops

MAX_HITS = 15          # saturation cap on GClock reference counts
EMPTY = -1             # tag value for an empty slot


class CacheState(NamedTuple):
    """Bookkeeping for a set-associative page cache (no payload storage).

    ``epoch`` versions each slot's dirty content: it is bumped on every
    ``mark_dirty`` and on every ``insert``, and :func:`clean_slot` may clear
    the dirty bit only while the epoch it captured is still current (the
    flush-completion lost-write race). ``None`` (states built without the
    field) disables the check.
    """

    tags: torch.Tensor    # (num_sets, set_size) int32, EMPTY = free slot
    hits: torch.Tensor    # (num_sets, set_size) int32 GClock counts
    dirty: torch.Tensor   # (num_sets, set_size) bool
    clock: torch.Tensor   # (num_sets,) int32 hand position
    epoch: Optional[torch.Tensor] = None  # (num_sets, set_size) int32 dirty version

    @property
    def num_sets(self) -> int:
        return self.tags.shape[0]

    @property
    def set_size(self) -> int:
        return self.tags.shape[1]


def make_cache(num_sets: int, set_size: int, device=None) -> CacheState:
    shape = (num_sets, set_size)
    return CacheState(
        tags=torch.full(shape, EMPTY, dtype=torch.int32, device=device),
        hits=torch.zeros(shape, dtype=torch.int32, device=device),
        dirty=torch.zeros(shape, dtype=torch.bool, device=device),
        clock=torch.zeros((num_sets,), dtype=torch.int32, device=device),
        epoch=torch.zeros(shape, dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# Scoring (paper section 3.3.1), over all sets at once
# ---------------------------------------------------------------------------

def distance_scores(state: CacheState) -> torch.Tensor:
    """(num_sets, set_size) distance_score = hits * set_size + distance."""
    s = state.set_size
    pos = torch.arange(s, dtype=torch.int32, device=state.tags.device)[None, :]
    return state.hits * s + torch.remainder(pos - state.clock[:, None], s)


def flush_scores(state: CacheState) -> torch.Tensor:
    """Rank-based flush scores, -1 for an empty slot (``policies.flush_scores``
    for every set), through ``ops.flush_scores``."""
    return ops.flush_scores(state.hits, state.clock, state.tags != EMPTY)


def dirty_counts(state: CacheState) -> torch.Tensor:
    return (state.dirty & (state.tags != EMPTY)).sum(dim=-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Per-set ops
# ---------------------------------------------------------------------------

def _int32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def lookup(state: CacheState, set_idx, tag):
    """Probe one set for ``tag``; bump its GClock hits on a hit.

    Returns (hit: bool 0-d, slot: int32 0-d, new_state)."""
    matches = state.tags[set_idx] == _int32(tag, state.tags.device)
    hit = matches.any()
    slot = matches.to(torch.int32).argmax().to(torch.int32)    # first match, 0 if none
    hits = state.hits.clone()
    bumped = torch.clamp(hits[set_idx, slot] + 1, max=MAX_HITS)
    hits[set_idx, slot] = torch.where(hit, bumped, hits[set_idx, slot])
    return hit, slot, state._replace(hits=hits)


def _evict_analytic(hits_row, clock, valid, dirty, clean_first: bool):
    """Analytic GClock sweep over one set. Returns (victim_slot, new_hits,
    new_clock), as ``policies.gclock_evict``, with its empty-slot fast path
    and the decrements of the simulated sweep."""
    s = hits_row.shape[0]
    pos = torch.arange(s, dtype=torch.int32, device=hits_row.device)
    dist = torch.remainder(pos - clock, s)
    score = hits_row * s + dist

    empty = ~valid
    has_empty = empty.any()
    first_empty = empty.to(torch.int32).argmax().to(torch.int32)

    clean = valid & ~dirty
    use_clean = clean.any() & bool(clean_first)
    eligible = torch.where(use_clean, clean, valid)

    masked = torch.where(eligible, score, torch.full_like(score, torch.iinfo(torch.int32).max))
    victim = masked.argmin().to(torch.int32)       # first minimum

    # Sweep decrements for eligible non-victim slots: slots with dist < dist_v
    # are visited h_v + 1 times before eviction, others h_v times.
    h_v = hits_row[victim]
    visits = torch.where(dist < dist[victim], h_v + 1, h_v)
    dec_hits = torch.clamp(hits_row - torch.where(eligible, visits, torch.zeros_like(visits)),
                           min=0)
    dec_hits[victim] = 0
    new_clock = torch.remainder(pos[victim] + 1, s)

    victim = torch.where(has_empty, first_empty, victim)
    new_hits = torch.where(has_empty, hits_row, dec_hits)
    new_clock = torch.where(has_empty, clock, new_clock)
    return victim, new_hits, new_clock


def insert(state: CacheState, set_idx, tag, dirty, clean_first: bool = True):
    """Insert ``tag`` into ``set_idx`` (the caller guarantees it is absent).

    Returns (victim_tag, victim_dirty, slot, new_state). victim_tag == EMPTY
    when a free slot was claimed; victim_dirty says a writeback is owed (the
    stall the flusher exists to prevent)."""
    dev = state.tags.device
    tags_row = state.tags[set_idx]
    dirty_row = state.dirty[set_idx]
    slot, new_hits_row, new_clock = _evict_analytic(
        state.hits[set_idx], state.clock[set_idx], tags_row != EMPTY, dirty_row, clean_first)
    victim_tag = tags_row[slot].clone()
    victim_dirty = (victim_tag != EMPTY) & dirty_row[slot]
    tags, hits, dirty_t, clock = (state.tags.clone(), state.hits.clone(),
                                  state.dirty.clone(), state.clock.clone())
    tags[set_idx, slot] = _int32(tag, dev)
    new_hits_row[slot] = 0
    hits[set_idx] = new_hits_row
    dirty_t[set_idx, slot] = torch.as_tensor(dirty, dtype=torch.bool, device=dev)
    clock[set_idx] = new_clock
    new_state = state._replace(tags=tags, hits=hits, dirty=dirty_t, clock=clock)
    if state.epoch is not None:
        # new occupant: in-flight flushes for the old content are dead, even
        # if the same tag is later re-inserted into this slot
        epoch = state.epoch.clone()
        epoch[set_idx, slot] += 1
        new_state = new_state._replace(epoch=epoch)
    return victim_tag, victim_dirty, slot, new_state


def mark_dirty(state: CacheState, set_idx, slot, value=True) -> CacheState:
    dev = state.tags.device
    value = torch.as_tensor(value, dtype=torch.bool, device=dev)
    dirty = state.dirty.clone()
    dirty[set_idx, slot] = value
    new_state = state._replace(dirty=dirty)
    if state.epoch is not None:
        # every write is a new dirty version; a no-op when cleaning
        epoch = state.epoch.clone()
        epoch[set_idx, slot] += value.to(torch.int32)
        new_state = new_state._replace(epoch=epoch)
    return new_state


def dirty_epoch_of(state: CacheState, set_idx, slot) -> torch.Tensor:
    """Dirty version to stamp into a FlushRequest at issue time."""
    assert state.epoch is not None, "cache built without epoch tracking"
    return state.epoch[set_idx, slot]


def clean_slot(state: CacheState, set_idx, slot, expect_tag,
               expect_epoch=None) -> CacheState:
    """Flush completion: clear dirty iff the slot still holds ``expect_tag``
    (paper section 3.3.2 staleness rule (i): the page may have been evicted)
    AND, when ``expect_epoch`` is given, no write re-dirtied the slot since
    the flush was issued (else a write landing between issue and completion
    would be dropped)."""
    dev = state.tags.device
    ok = state.tags[set_idx, slot] == _int32(expect_tag, dev)
    if expect_epoch is not None and state.epoch is not None:
        ok = ok & (state.epoch[set_idx, slot] == _int32(expect_epoch, dev))
    dirty = state.dirty.clone()
    dirty[set_idx, slot] = dirty[set_idx, slot] & ~ok
    return state._replace(dirty=dirty)


# ---------------------------------------------------------------------------
# Flush candidate selection (paper section 3.3), all sets at once
# ---------------------------------------------------------------------------

def select_flush_candidates(state: CacheState, trigger: int, per_set: int):
    """For every set with > ``trigger`` dirty pages, pick the ``per_set`` dirty
    pages with the highest flush scores.

    Returns (set_mask (num_sets,), slots (num_sets, per_set) int32 with -1
    padding, scores (num_sets, per_set) int32). ``torch.topk`` orders equal
    values in no promised order, where ``jax.lax.top_k`` takes the lower
    index first; but the valid scores of a set are distinct (a permutation),
    so ties are only among the -1s, whose slots are masked to -1."""
    fs = flush_scores(state)
    eligible = state.dirty & (state.tags != EMPTY)
    masked = torch.where(eligible, fs, torch.full_like(fs, -1))
    scores, slots = torch.topk(masked, per_set, dim=-1)
    slots = torch.where(scores >= 0, slots.to(torch.int32), torch.full_like(scores, -1))
    set_mask = dirty_counts(state) > trigger
    slots = torch.where(set_mask[:, None], slots, torch.full_like(slots, -1))
    return set_mask, slots, scores
