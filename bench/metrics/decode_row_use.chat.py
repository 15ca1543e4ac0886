"""Engine: the share of the rows a decode step computes that hold an active
request (``ServeEngine.stats()``: ``decode_rows_active`` over
``decode_rows_computed``, the batch every step runs), over the window."""
NAME, UNIT, SOURCE = "decode_row_use.chat", "%", "program_counter"
LAYER, MOVES = "engine", "itl_p50_ms"


def read(run):
    st = run["stats"]
    n = st.get("decode_rows_computed")
    return 100.0 * st["decode_rows_active"] / n if n else None
