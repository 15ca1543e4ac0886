"""The sweep that chose the chat cell's rate: a rate's readings on the CPU
at the tests' size, and the knee rule over made-up rows."""
from __future__ import annotations

import pytest
import torch

from bench_small import small_cell
import model
from reference import family
import sweep


def test_sweep_rate_reads_a_rate():
    cell, conf = small_cell("olmoe-chat-pressure")
    cfg = model.port_config(conf)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        row = sweep.sweep_rate(cell, cfg, family(conf).draw_params(conf["port"], 5, "cpu"),
                               10.0, 5, 1.0, "cpu")
    finally:
        torch.set_num_threads(n)
    assert row["requests"] == 10 and row["steps"] > 0
    assert row["mean_live_pages"] > 0 and row["mean_active_rows"] > 0
    # a third in which no step ended (a slow, loaded CPU) reads nan
    waiting = [row[f"waiting_{k}_third"] for k in ("first", "middle", "last")]
    assert not any(w < 0 for w in waiting) and any(w >= 0 for w in waiting)
    assert row["backlog_grows"] == sweep.grows(row)


@pytest.mark.parametrize("grow, want", [
    ([False, False, True, True], (1.2, 0.96)),
    ([False, True, False, False], (1.0, 0.8)),     # a rate past a growing one never counts
    ([True, False, False, False], (None, None)),
    ([False, False, False, False], (1.8, 1.44)),
])
def test_knee_is_the_highest_rate_below_the_first_growth(grow, want):
    rows = [{"rate": r, "backlog_grows": g} for r, g in zip((1.0, 1.2, 1.4, 1.8), grow)]
    assert sweep.choose_rate(rows[::-1]) == want


def test_growth_compares_the_last_third_with_the_middle():
    row = {"waiting_first_third": 0.0, "waiting_middle_third": 2.0, "waiting_last_third": 2.9}
    assert not sweep.grows(row)
    assert sweep.grows({**row, "waiting_last_third": 3.1})
