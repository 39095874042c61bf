"""Autograd below the compositor (the head and the final U-Net): the "backward" span's device ms (CUDA events, no
synchronise), median a step over the steps profiled alone
(``stages.last_trace()``); the unsynchronised twin of ``backward_ms.train``."""


def read(trace):
    from pose_splatter_torch.utils import stages

    last = getattr(stages, "last_trace", None)  # absent before span tracing
    spans = last() if last is not None else None
    if spans is None:
        return None
    return spans.stage_ms("backward")
