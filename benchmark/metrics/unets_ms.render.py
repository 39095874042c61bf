"""The U-Nets: the "unets" stage, median ms a frame."""


def read(trace):
    return trace.stage_ms("unets")
