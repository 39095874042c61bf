"""The carve: the "carve" stage, median ms a frame."""


def read(trace):
    return trace.stage_ms("carve")
