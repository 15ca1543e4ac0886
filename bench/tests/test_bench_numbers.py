"""The host-clock numbers of the serving cell: percentiles as numpy takes
them, and a request that never answered counted as infinitely late."""
from __future__ import annotations

import math

import numpy as np
import pytest

import bench_small  # noqa: F401  (the import path)
import common
import serve

VALUES = [12.0, 3.5, 7.25, 40.0, 3.5, 18.0, 9.0]


@pytest.mark.parametrize("q", [0, 25, 50, 90, 95, 100])
def test_percentile_is_numpys_linear(q):
    assert common.percentile(VALUES, q) == pytest.approx(float(np.percentile(VALUES, q)))


def test_percentile_ranks_an_unanswered_request_last():
    assert common.percentile(VALUES + [math.inf], 50) == pytest.approx(
        float(np.percentile(VALUES + [1e9], 50)))
    assert common.percentile(VALUES + [math.inf], 100) == math.inf
    assert math.isnan(common.percentile([], 50))


def test_latencies_from_due_time_and_between_tokens():
    a = serve.Track(1.0, [5, 6], 0)
    a.times = [1.25, 1.30, 1.40]
    b = serve.Track(2.0, [7], 1)                    # submitted, never answered
    ttft, itl = serve.latencies({0: a, 1: b}, unsubmitted=2)
    assert ttft[0] == pytest.approx(250.0) and ttft[1:] == [math.inf] * 3
    assert itl == pytest.approx([50.0, 100.0])
