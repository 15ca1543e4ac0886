"""Prefill: span ``serve.prefill`` inside ``ServeEngine._prefill_row``
(``stats()["prefill_s"]``) over the prompt tokens it took
(``prefill_tokens``), in ms a 1,000 tokens; the engine's own reading of
what ``prefill_ms_per_ktok.chat`` times from outside."""
NAME, UNIT, SOURCE = "engine_prefill_ms_per_ktok.chat", "ms", "program_span"
LAYER, MOVES = "prefill", "itl_p50_ms"


def read(run):
    st = run["stats"]
    n = st.get("prefill_tokens")
    return st["prefill_s"] * 1e3 / n * 1e3 if n else None
