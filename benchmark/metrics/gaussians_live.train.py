"""Gaussians the selection kept a step (its valid slots, at most
``max_n``), median over the steps profiled alone: the program's selection
record a call (``stages.selected``), summed over a step's calls. A count
at ``max_n`` with more voxels above the threshold than that is the
adaptive threshold's opacity-starvation regime."""


def read(trace):
    from pose_splatter_torch.utils import stages

    last = getattr(stages, "last_trace", None)  # absent before span tracing
    spans = last() if last is not None else None
    if spans is None or "gaussians_live" not in spans.units[0]:
        return None  # a program without the selection record
    return spans.median("gaussians_live")
