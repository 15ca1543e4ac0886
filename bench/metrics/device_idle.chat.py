"""Device: the share of the traced part of the window in which no
operation ran on the card (``torch.profiler``'s device events)."""
NAME, UNIT, SOURCE = "device_idle.chat", "%", "device_trace"
LAYER, MOVES = "device", "itl_p50_ms"


def read(run):
    t = run["trace"]
    if not t or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
