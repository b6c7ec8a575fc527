"""serving.py, host side: the median host time of one request in the
traced slice; the program's ``GraphedFunction.__call__`` (weight check,
input copy, replay, output clones) in the rig cell, one iteration of
``serve_stream`` (with ``pinned_put``'s staging) in the backlog cell."""
import statistics


def read(r):
    calls = r.spans.get("serve_call")
    return statistics.median(calls) * 1e3 if calls else None
