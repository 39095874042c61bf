"""The largest device memory in tensors a unit held (a step; a K-step
call in K-step cells), in GB (1e9 bytes): the CUDA caching allocator's
``allocated_bytes`` read at each span boundary of the unit
(``stages.last_trace()``'s ``max_allocated_bytes``, a host statistic),
median over the units profiled alone."""


def read(trace):
    from pose_splatter_torch.utils import stages

    last = getattr(stages, "last_trace", None)  # absent before span tracing
    spans = last() if last is not None else None
    if spans is None or "max_allocated_bytes" not in spans.units[0]:
        return None  # a program without the memory counter
    value = spans.median("max_allocated_bytes")
    return None if value is None else value / 1e9
