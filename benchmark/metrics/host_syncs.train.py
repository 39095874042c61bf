"""Blocking reads of the device the program made a step (its count
``host_syncs``: the selection flag's read and every other call that
waits for the device), median over the steps profiled alone."""


def read(trace):
    from pose_splatter_torch.utils import stages

    last = getattr(stages, "last_trace", None)  # absent before span tracing
    spans = last() if last is not None else None
    if spans is None:
        return None
    return spans.median("host_syncs")
