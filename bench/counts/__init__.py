"""Frozen operation counts, from shapes alone, and the peak they are read
against: NVIDIA H100 SXM, dense bfloat16 989 TFLOP/s (the data sheet's
rate at the 700 W limit; a run prints the card's ``power.limit`` beside
its numbers).

The sizes are a configuration file's ``port`` section; nothing here reads
the program's own cost formulas. What depends on the model family (its
parameters a token multiplies by, a training step's FLOPs) is in the
family's module beside this one, ``counts/<family>.py``, found by the
configuration's ``"reference"`` key (``family``).
"""
from __future__ import annotations

import importlib

PEAK_FLOPS = 989e12


def causal_pairs(s: int) -> int:
    """(query, key) pairs of causal attention over s positions."""
    return s * (s + 1) // 2


def flash_fwd_flops(b: int, h: int, hd: int, s: int) -> int:
    """QK^T and PV over the causal pairs."""
    return 4 * b * h * hd * causal_pairs(s)


def flash_bwd_flops(b: int, h: int, hd: int, s: int) -> int:
    """The backward's five products (S and dP formed again, dV, dK, dQ)."""
    return 10 * b * h * hd * causal_pairs(s)


def family(conf: dict):
    """The counts module of the configuration's model family."""
    return importlib.import_module(f"{__name__}.{conf['reference']}")
