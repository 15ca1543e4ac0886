"""Prefill: ``ServeEngine._prefill_row`` (``models/transformer.py::prefill``
with the flash forward, and the page writes), its span ending at the first
token's host copy; total ms over the prompt tokens it took, per 1,000. The
engine prefills inside ``step()``, so a prefill also lengthens the gap
between tokens of every row active in that step."""
NAME, UNIT, SOURCE = "prefill_ms_per_ktok.chat", "ms", "program_span"
LAYER, MOVES = "prefill", "itl_p50_ms"


def read(run):
    toks = sum(run["spans"].values.get("prompt_tokens", []))
    return run["spans"].total["prefill"] * 1e3 / toks * 1e3 if toks else None
