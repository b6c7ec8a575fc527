"""kernels/window_attention.py (K1): the least time its launches in the
traced slice need (bf16 operands, f32 bias and mask, at 3.35 TB/s or
989 TFLOP/s, whichever bounds each call; the calls of a request are the
trunk family's ``k1_calls``) over their device time, in %."""
from benchmark.reference import kernel_calls
from benchmark.work import bound, k1_bytes_flops


def read(r):
    seconds, launches = r.trace.kernel_seconds("window_attention_kernel")
    calls = kernel_calls(r.config, "k1", r.batch)
    if not calls or not launches or seconds <= 0:
        return None
    least = sum(bound(*k1_bytes_flops(*c, itemsize=2))[0] for c in calls)
    return 100.0 * least * (launches / len(calls)) / seconds
