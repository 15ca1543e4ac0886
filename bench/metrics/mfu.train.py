"""The train step (``launch/steps.py``, ``optim/adamw.py``): its model
FLOPs (the configuration's family's ``train_step_flops`` in ``counts/``:
6 x active parameters x tokens plus causal attention) over the measured
step time at 989 TFLOP/s."""
import counts

NAME, UNIT, SOURCE = "mfu.train", "%", "program_span"
LAYER, MOVES = "train step", "train_tokens_per_s"


def read(run):
    n = run["spans"].count.get("train_step", 0)
    if not n:
        return None
    sz, b, s = run["conf"]["port"], run["batch"], run["seq"]
    step_s = run["spans"].total["train_step"] / n
    flops = counts.family(run["conf"]).train_step_flops(sz, b, s)
    return 100.0 * flops / step_s / counts.PEAK_FLOPS
