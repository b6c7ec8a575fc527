"""kernels/global_attention.py, forward (K6): the least time its launches
in the traced slice need (bf16 q, k, v and output, the f32 bias) over
their device time, in %."""
from benchmark.work import beit_attention, bound, k6_bytes_flops


def read(r):
    seconds, launches = r.trace.kernel_seconds("global_attention_kernel")
    if not launches or seconds <= 0:
        return None
    least = bound(*k6_bytes_flops(*beit_attention(r.config["backbone"], r.batch), 2, 4))[0]
    return 100.0 * least * launches / seconds
