"""Decode step: the share of the window's decode steps that replayed the
engine's captured CUDA graph (``ServeEngine.stats()``:
``decode_graph_replays`` over ``decode_steps``), in %. None where the
engine counts no replays (a program that launches the step eagerly)."""
NAME, UNIT, SOURCE = "decode_graph_share.chat", "%", "program_counter"
LAYER, MOVES = "decode step", "itl_p50_ms"


def read(run):
    st = run["stats"]
    n, replays = st.get("decode_steps"), st.get("decode_graph_replays")
    if not n or replays is None:
        return None
    return 100.0 * replays / n
