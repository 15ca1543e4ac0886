"""Kernel ``kernels/csrc/flash_attention_bwd.cu``: the five products' causal
FLOPs a call (``counts.flash_bwd_flops``) at 989 TFLOP/s over the device
time of a call, its D, dK/dV and dQ kernels summed (calls: the dK/dV
launches in the traced steps)."""
from common import kernel_seconds
import counts

NAME, UNIT, SOURCE = "flash_bwd_roofline.train", "%", "device_trace"
LAYER, MOVES = "kernels", "train_tokens_per_s"


def read(run):
    t = run["trace"]
    if not t:
        return None
    s, _ = kernel_seconds(t, "dot_kernel", "dkv_kernel", "dq_kernel")
    _, calls = kernel_seconds(t, "dkv_kernel")
    if not calls:
        return None
    sz = run["conf"]["port"]
    call = counts.flash_bwd_flops(run["micro_rows"], sz["n_heads"], sz["head_dim"], run["seq"])
    return 100.0 * call / counts.PEAK_FLOPS / (s / calls)
