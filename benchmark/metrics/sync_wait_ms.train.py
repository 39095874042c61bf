"""Host ms blocked in the program's reads of the device a step (its
"sync" spans), median over the steps profiled alone."""


def read(trace):
    from pose_splatter_torch.utils import stages

    last = getattr(stages, "last_trace", None)  # absent before span tracing
    spans = last() if last is not None else None
    if spans is None:
        return None
    return spans.median("sync_wait_ms")
