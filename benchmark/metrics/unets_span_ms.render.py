"""The U-Nets: the "unets" span's device ms (CUDA events, no
synchronise), median a frame over the frames profiled alone
(``stages.last_trace()``); the unsynchronised twin of ``unets_ms.render``."""


def read(trace):
    from pose_splatter_torch.utils import stages

    last = getattr(stages, "last_trace", None)  # absent before span tracing
    spans = last() if last is not None else None
    if spans is None:
        return None
    return spans.stage_ms("unets")
