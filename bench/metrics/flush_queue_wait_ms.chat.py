"""Offload tier: how long a flush (a LOW-priority page offload) waited in
its target's queue, from ``IOExecutor.submit`` to its issue, over the
flushes issued in the window (``ServeEngine.stats()``: ``flush_wait_s``
over ``flush_issued``, summed over the targets), in ms. A stale flush,
discarded at the queue's head, is not issued and not counted."""
NAME, UNIT, SOURCE = "flush_queue_wait_ms.chat", "ms", "program_span"
LAYER, MOVES = "offload tier", "itl_p50_ms"


def read(run):
    st = run["stats"]
    n = st.get("flush_issued")
    return st["flush_wait_s"] / n * 1e3 if n else None
