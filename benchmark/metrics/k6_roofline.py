"""kernels/global_attention.py, forward (K6): the least time its launches
in the traced slice need (bf16 q, k, v and output, the bias where the
call has one; the calls of a request are the trunk family's
``k6_calls``) over their device time, in %."""
from benchmark.reference import kernel_calls
from benchmark.work import bound, k6_bytes_flops


def read(r):
    seconds, launches = r.trace.kernel_seconds("global_attention_kernel")
    calls = kernel_calls(r.config, "k6", r.batch)
    if not calls or not launches or seconds <= 0:
        return None
    least = sum(bound(*k6_bytes_flops(B, H, T, d, 2, bias))[0] for B, H, T, d, bias in calls)
    return 100.0 * least * (launches / len(calls)) / seconds
