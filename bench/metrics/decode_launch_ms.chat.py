"""Decode step: the host's enqueue of a step's launches
(``ServeEngine.stats()["decode_launch_s"]``, span ``serve.decode.launch``
inside the engine's ``step_fn``, ending when the call returns) over the
window's decode steps, in ms."""
NAME, UNIT, SOURCE = "decode_launch_ms.chat", "ms", "program_span"
LAYER, MOVES = "decode step", "itl_p50_ms"


def read(run):
    st = run["stats"]
    n = st.get("decode_steps")
    return st["decode_launch_s"] / n * 1e3 if n else None
