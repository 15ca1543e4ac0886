"""Decode step: span ``serve.decode``'s self time, its time less the lock's
wait and the launches (``ServeEngine.stats()``: ``decode_s - decode_lock_s
- decode_launch_s``), over the window's decode steps, in ms: the inputs'
copies to the card and the host's wait for the device after the last
launch, until the step's tokens are on the host."""
NAME, UNIT, SOURCE = "decode_wait_ms.chat", "ms", "program_span"
LAYER, MOVES = "decode step", "itl_p50_ms"


def read(run):
    st = run["stats"]
    n = st.get("decode_steps")
    if not n:
        return None
    return (st["decode_s"] - st["decode_lock_s"] - st["decode_launch_s"]) / n * 1e3
