"""train_tokens_per_s: the tokens of every step completed in the window
over the window's seconds."""
NAME, UNIT, SOURCE = "train_tokens_per_s", "tokens/s", "host_clock"


def read(run):
    return run["tokens"] / run["window_s"]
