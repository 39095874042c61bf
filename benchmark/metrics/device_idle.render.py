"""Share of the profiled wall time in which no device operation ran,
percent, over units under the profiler alone (no marks)."""


def read(trace):
    p = trace.profile
    if p is None or p.window_s <= 0 or not p.device:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
