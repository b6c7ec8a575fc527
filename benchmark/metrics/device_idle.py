"""The device: the share of an iteration's wall in which no kernel, copy or
memset ran, in %: the device time an iteration takes in the traced slice
over the wall an iteration takes before it, untraced (recording the
device slows the host's launches, so the slice's own wall would read a
host-bound request as idler than it is)."""


def read(r):
    if not r.trace.device or not r.units or not r.unit_wall_s:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.units / r.unit_wall_s)
