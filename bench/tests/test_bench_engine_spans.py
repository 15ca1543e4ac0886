"""The chat cell's metrics read from the engine's own spans and counters
(``ServeEngine.stats()``): a small traced run on the CPU reports each as a
number, and a run record without those counters (a program that lacks
them) reports none of them and raises nothing."""
from __future__ import annotations

import math

import pytest
import torch

from bench_small import run_small
import common

ENGINE_METRICS = ["decode_lock_wait_ms.chat", "decode_launch_ms.chat", "decode_wait_ms.chat",
                  "decode_row_use.chat", "engine_prefill_ms_per_ktok.chat",
                  "flush_queue_wait_ms.chat", "offload_page_ms.chat",
                  "host_tier_stall_ms_per_ktok.chat"]


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_traced_chat_run_reports_the_engine_metrics():
    res = run_small("olmoe-chat-pressure", seconds=1.0, trace=True)
    assert res["correct"], res["checks"]
    for name in ENGINE_METRICS:
        value = res["metrics"][name]["value"]
        assert isinstance(value, float) and math.isfinite(value) and value >= 0, name
    assert 0 < res["metrics"]["decode_row_use.chat"]["value"] <= 100


@pytest.mark.parametrize("name", ENGINE_METRICS)
def test_reader_finds_nothing_without_the_counters(name):
    run = {"stats": {"offloads": 3, "blocking_offloads": 1, "preemptions": 0},
           "out_tokens": 100}
    assert common.load_module("metrics", name).read(run) is None
