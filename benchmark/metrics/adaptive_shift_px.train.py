"""The largest shift of a principal point that the adaptive camera's
``temp_K`` makes against the rig's intrinsics, over the views, in pixels,
median over the steps profiled alone: the program's record an adaptive
forward (``stages.adaptive``). A program without that record, or a step
without an adaptive forward, gives nothing."""


def read(trace):
    from pose_splatter_torch.utils import stages

    last = getattr(stages, "last_trace", None)  # absent before span tracing
    spans = last() if last is not None else None
    if spans is None or "adaptive_shift_px" not in spans.units[0]:
        return None  # a program without the adaptive record
    return spans.median("adaptive_shift_px")
