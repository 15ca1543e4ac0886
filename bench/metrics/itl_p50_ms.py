"""itl_p50_ms: the median of every gap between successive tokens of the
requests due in the window, a preempted request's wait included."""
import math

from common import percentile

NAME, UNIT, SOURCE = "itl_p50_ms", "ms", "host_clock"


def read(run):
    v = percentile(run["itl_ms"], 50)
    return v if math.isfinite(v) else None
