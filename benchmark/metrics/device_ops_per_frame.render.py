"""Device operations a frame (kernels, memsets and copies) in the
profiler's trace of frames under the profiler alone: what the host
launches for each frame."""


def read(trace):
    p = trace.profile
    if p is None or not p.device:
        return None
    return len(p.device) / p.units
