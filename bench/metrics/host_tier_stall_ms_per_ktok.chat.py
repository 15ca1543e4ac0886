"""Offload tier: the engine thread's time stalled on the host tier, its
blocking offloads (span ``serve.offload_blocking``) and its resumes' waits
for their HIGH-priority fetches (span ``serve.fetch_wait``)
(``ServeEngine.stats()``: ``blocking_offload_s + fetch_wait_s``), in ms a
1,000 output tokens of the window."""
NAME, UNIT, SOURCE = "host_tier_stall_ms_per_ktok.chat", "ms", "program_span"
LAYER, MOVES = "offload tier", "itl_p50_ms"


def read(run):
    st, n = run["stats"], run["out_tokens"]
    if not n or "blocking_offload_s" not in st:
        return None
    return (st["blocking_offload_s"] + st["fetch_wait_s"]) * 1e3 / n * 1e3
