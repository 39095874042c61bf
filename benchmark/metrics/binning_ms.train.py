"""Binning (in 3D with the projection and depth sort): the "binning" stage, median ms a step."""


def read(trace):
    return trace.stage_ms("binning")
