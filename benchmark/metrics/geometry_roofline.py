"""ops/geometry.py, the 1080p tail after the bicubic resize, which the
program runs as one kernel (kernels/unproject_slots.py): the least time its
launches in the traced slice need (each pixel's inverse depth read once,
its point and its slot key written once, 20 bytes, at 3.35 TB/s; a launch
covers a request's pixels, batch x the camera's height x width) over their
device time, in %. Nothing read where no kernel's name holds
``unproject_slots``: a program that runs the tail as aten passes."""
from benchmark.work import bound

KERNEL = "unproject_slots"
BYTES_PER_PIXEL = 20  # inverse depth in (4), point out (12), slot out (4)


def tail_bytes(pixels: int) -> int:
    return pixels * BYTES_PER_PIXEL


def read(r):
    seconds, launches = r.trace.kernel_seconds(KERNEL)
    if not launches or seconds <= 0:
        return None
    cam = r.config["camera"]
    least = bound(tail_bytes(r.batch * cam["height"] * cam["width"]), 0)[0]
    return 100.0 * least * launches / seconds
