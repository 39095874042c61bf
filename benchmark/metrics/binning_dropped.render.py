"""Rows the binning's caps dropped over the rows it was asked to bin,
percent, summed over the binning calls of the frames profiled alone
(the program's record a call)."""


def read(trace):
    from pose_splatter_torch.utils import stages

    last = getattr(stages, "last_trace", None)  # absent before span tracing
    spans = last() if last is not None else None
    if spans is None:
        return None
    kept = sum(u["binned_rows"] for u in spans.units)
    dropped = sum(u["dropped_rows"] for u in spans.units)
    if kept + dropped <= 0:
        return None
    return 100.0 * dropped / (kept + dropped)
