"""The carve: the "carve" stage, median ms a step."""


def read(trace):
    return trace.stage_ms("carve")
