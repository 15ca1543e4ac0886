"""Kernel ``kernels/csrc/flash_attention.cu`` in training (the forward and
its recompute under remat): causal FLOPs a call (``counts.flash_fwd_flops``
at the microbatch's shape) at 989 TFLOP/s over the device time a launch
in the traced steps."""
from common import kernel_seconds
import counts

NAME, UNIT, SOURCE = "flash_fwd_roofline.train", "%", "device_trace"
LAYER, MOVES = "kernels", "train_tokens_per_s"


def read(run):
    t = run["trace"]
    if not t:
        return None
    s, n = kernel_seconds(t, "flash_wgmma_kernel", "flash_attention_kernel")
    if not n:
        return None
    sz = run["conf"]["port"]
    call = counts.flash_fwd_flops(run["micro_rows"], sz["n_heads"], sz["head_dim"], run["seq"])
    return 100.0 * call / counts.PEAK_FLOPS / (s / n)
