"""Offload tier: the decode step's wait for the engine's pool lock
(``ServeEngine.stats()["decode_lock_s"]``, span ``serve.decode.lock``),
which a background page copy-out holds while it runs, over the window's
decode steps, in ms. The lock's other side is ``offload_page_ms.chat``."""
NAME, UNIT, SOURCE = "decode_lock_wait_ms.chat", "ms", "program_span"
LAYER, MOVES = "offload tier", "itl_p50_ms"


def read(run):
    st = run["stats"]
    n = st.get("decode_steps")
    return st["decode_lock_s"] / n * 1e3 if n else None
