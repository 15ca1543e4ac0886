"""Offload tier: one background page copy-out on an IO thread, its wait
for the engine's pool lock included (span ``kv.offload`` in
``PagedKVPool._do_io``; ``ServeEngine.stats()``: ``offload_io_s`` over
``offload_io_n``), in ms."""
NAME, UNIT, SOURCE = "offload_page_ms.chat", "ms", "program_span"
LAYER, MOVES = "offload tier", "itl_p50_ms"


def read(run):
    st = run["stats"]
    n = st.get("offload_io_n")
    return st["offload_io_s"] / n * 1e3 if n else None
