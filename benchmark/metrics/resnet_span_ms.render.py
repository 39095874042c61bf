"""ResNet-18 of the feature stage (the ImageNet normalisation and the
network over the rig's views): the "resnet" span's device ms (CUDA events,
no synchronise), median a frame over the frames profiled alone
(``stages.last_trace()``)."""


def read(trace):
    from pose_splatter_torch.utils import stages

    last = getattr(stages, "last_trace", None)
    spans = last() if last is not None else None
    if spans is None:
        return None
    return spans.stage_ms("resnet")
