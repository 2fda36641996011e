"""The share of the traced window in which no device operation runs (the
union of the profiler's kernel, copy and set intervals), in %."""


def read(r):
    if r.trace is None or not r.trace.device or r.trace.window_s <= 0:
        return None
    return (1.0 - r.trace.busy_s() / r.trace.window_s) * 100.0
