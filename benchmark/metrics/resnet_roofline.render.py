"""ResNet-18's share of its roofline, percent: its convolutions' FLOPs a
frame (``benchmark/resnet.py``, at the renders' size and count, which the
marked frames' "resnet" marks kept) over the "resnet" span's device
seconds (median a frame over the frames profiled alone), against the
card's float32 peak without tensor cores (67 TFLOP/s; TF32 is off). Every
convolution is compute-bound at these sizes, so the FLOP rate is the
roofline."""

from benchmark.counts import PEAK_FP32
from benchmark.resnet import flops


def read(trace):
    from pose_splatter_torch.utils import stages

    renders = trace.values.get("resnet") or []
    last = getattr(stages, "last_trace", None)
    spans = last() if last is not None else None
    ms = spans.stage_ms("resnet") if spans is not None else None
    if not renders or not ms:
        return None
    views, height, width = renders[0].shape[:3]
    if height != width:
        return None
    return 100.0 * views * flops(height) / (1e-3 * ms * PEAK_FP32)
