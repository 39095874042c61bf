"""The composite fwd kernel's share of its roofline, percent: the
least seconds of the marked calls (``benchmark/counts.py``, on the arrays
they binned) over the same calls' device seconds in the profiler's trace,
every device operation of a call counted."""


def read(trace):
    return trace.roofline("composite_fwd")
