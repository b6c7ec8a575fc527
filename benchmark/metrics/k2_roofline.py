"""kernels/segment_sum.py (K2): the least time its launches in the
traced slice need (every row's key, the kept rows' values, and the grid
rows the kernel reduces into; rows and cells counted on the requests the
slice recorded) over the kernel's device time, in %. The memset that
zeroes the grid before it is a launch of its own and is not counted."""
from benchmark.work import bound, k2_bytes


def read(r):
    seconds, calls = r.trace.kernel_seconds("segment_sum_kernel")
    if not calls or seconds <= 0 or not r.k2_requests:
        return None
    cam, C = r.config["camera"], r.config["num_classes"]
    rows = r.batch * cam["height"] * cam["width"]
    least = sum(bound(k2_bytes(rows, kept, cells, C), 0)[0] for kept, cells in r.k2_requests)
    return 100.0 * least / len(r.k2_requests) * calls / seconds
