"""Model FLOPs a frame (``benchmark/counts.py::model_flops``) over the
time of the traced run's plain frames (no marks, no profiler) at the
card's float32 peak without tensor cores (67 TFLOP/s), percent."""

from benchmark.counts import PEAK_FP32


def read(trace):
    if trace.mfu_seconds <= 0 or trace.mfu_flops <= 0:
        return None
    return 100.0 * trace.mfu_flops / (trace.mfu_seconds * PEAK_FP32)
