"""Decode step: ``ServeEngine.step_fn`` (``serving/paged_model.py``), each
call's span ending at a synchronize; all of their time over their count."""
NAME, UNIT, SOURCE = "decode_step_ms.chat", "ms", "program_span"
LAYER, MOVES = "decode step", "itl_p50_ms"


def read(run):
    n = run["spans"].count.get("decode", 0)
    return run["spans"].total["decode"] / n * 1e3 if n else None
