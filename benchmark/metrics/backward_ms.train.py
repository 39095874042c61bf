"""Autograd below the compositor (the head and the final U-Net): the gap from the "kernel_bwd" mark to the "backward" mark, median ms a step."""


def read(trace):
    return trace.stage_ms("backward")
