"""The traffic generators repeat exactly for a seed and differ across
seeds; the chat generator's stratified draws keep every seed's total work
close."""
from __future__ import annotations

import collections

import pytest

from bench_small import small_cell
import common

BIG = 2 ** 31 + 12345            # seeds run past 32 signed bits


def _gen(name, seed):
    cell, conf = small_cell(name)
    mod = common.load_module("traffic", cell["traffic_kind"])
    return mod.generate(cell["traffic_params"], seed, 2.0, conf["port"]["vocab"])


@pytest.mark.parametrize("name", ["olmoe-chat-pressure"])
def test_serving_traffic(name):
    a, b, c = _gen(name, BIG), _gen(name, BIG), _gen(name, BIG + 1)
    assert a == b and a != c
    sizes = lambda w: collections.Counter((len(x[-2]), x[-1]) for x in w)
    assert sizes(a) != sizes(c)                     # the seed draws the lengths too
    for k in (1, 2):
        ta, tc = (sum(len(x[k]) if k == 1 else x[k] for x in w) for w in (a, c))
        assert abs(ta - tc) <= 0.05 * ta
    dues = [x[0] for x in a]
    assert dues == sorted(dues) and 0 < dues[0] and dues[-1] < 2.0
    assert [x[0] for x in c] != dues


def test_chat_lengths_follow_the_distribution():
    """Stratified lognormal draws: a seed's median and quartiles lie near the
    distribution's at the cell's own size."""
    import numpy as np

    cell = common.load_json("workloads", "olmoe-chat-pressure")
    mod = common.load_module("traffic", cell["traffic_kind"])
    p = cell["traffic_params"]
    work = mod.generate(p, BIG, 50.0, 50304)
    assert len(work) == round(p["rate"] * 50.0)
    for k, q in ((1, p["prompt"]), (2, p["output"])):
        xs = np.array([len(x[k]) if k == 1 else x[k] for x in work], dtype=float)
        assert abs(np.median(xs) / q["median"] - 1) < 0.1
        iqr = np.log(np.percentile(xs, 75) / np.percentile(xs, 25))
        assert abs(iqr / (2 * 0.6745 * q["sigma"]) - 1) < 0.15


def test_chat_lengths_within_limits():
    cell, conf = small_cell("olmoe-chat-pressure")
    p = cell["traffic_params"]
    for _, prompt, out in _gen("olmoe-chat-pressure", 5):
        assert p["prompt"]["lo"] <= len(prompt) <= p["prompt"]["hi"]
        assert p["output"]["lo"] <= out <= p["output"]["hi"]
        assert all(0 < t < conf["port"]["vocab"] for t in prompt)


def test_train_batches():
    cell, conf = small_cell("granite-train-4k")
    mod = common.load_module("traffic", cell["traffic_kind"])
    tp, v = cell["traffic_params"], conf["port"]["vocab"]
    a, b = mod.batch(tp, BIG, 3, v), mod.batch(tp, BIG, 3, v)
    assert all((a[k] == b[k]).all() for k in a)
    assert not (a["tokens"] == mod.batch(tp, BIG, 4, v)["tokens"]).all()
    assert not (a["tokens"] == mod.batch(tp, BIG + 1, 3, v)["tokens"]).all()
    assert (a["tokens"][:, 1:] == a["labels"][:, :-1]).all()
    assert a["tokens"].shape == (tp["batch"], tp["seq"]) and a["tokens"].max() < v
    assert len({r.tobytes() for r in a["tokens"]}) == tp["batch"]


@pytest.mark.parametrize("seed", [0, 7, BIG, 2 ** 40 + 3])
def test_chat_work_is_steady_across_seeds(seed):
    """At the cell's own rate and window, each seed's prompt and output
    tokens lie within 3 % of seed 1's, and the arrivals lie inside the
    window."""
    cell = common.load_json("workloads", "olmoe-chat-pressure")
    mod = common.load_module("traffic", cell["traffic_kind"])
    p = cell["traffic_params"]
    ref, got = mod.generate(p, 1, 50.0, 50304), mod.generate(p, seed, 50.0, 50304)
    for k in (1, 2):
        total = lambda w: sum(len(x[k]) if k == 1 else x[k] for x in w)
        assert abs(total(got) / total(ref) - 1) < 0.03
    assert 0 < got[0][0] < got[-1][0] < 50.0 and len(got) == len(ref)
