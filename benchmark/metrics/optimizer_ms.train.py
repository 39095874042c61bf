"""Adam over the net's parameters: the "optimizer" stage (the gap from the "backward" mark), median ms a step."""


def read(trace):
    return trace.stage_ms("optimizer")
