"""The models, whole: operations of one request (counted on the
plain reference at the cell's shapes) over the wall an iteration takes
untraced and the card's bf16 peak, in %."""
from benchmark.work import PEAK_FLOPS


def read(r):
    if not r.trace.device or not r.unit_wall_s:
        return None
    return 100.0 * r.flops_per_unit() / r.unit_wall_s / PEAK_FLOPS["bfloat16"]
