"""Offload tier: ``ServeEngine.stats()["blocking_offloads"]`` over the
window (offloads a preemption or an eviction waited for, as the flusher
had not cleaned the page), per 1,000 output tokens. Each one holds up the
step it falls in, and so the gap between tokens of every active row."""
NAME, UNIT, SOURCE = "blocking_offloads_per_ktok.chat", "count", "program_counter"
LAYER, MOVES = "offload tier", "itl_p50_ms"


def read(run):
    n = run["out_tokens"]
    return run["stats"]["blocking_offloads"] / n * 1e3 if n else None
