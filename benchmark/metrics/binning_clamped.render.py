"""Gaussians whose tile span the binning clamped to its ``tile_expand``
over the Gaussians it binned (those overlapping a camera's image, counted
a camera), percent, summed over the binning calls of the frames profiled
alone (the program's record a call)."""


def read(trace):
    from pose_splatter_torch.utils import stages

    last = getattr(stages, "last_trace", None)
    spans = last() if last is not None else None
    if spans is None:
        return None
    clamped = [u.get("clamped_gaussians") for u in spans.units]
    binned = [u.get("binned_gaussians") for u in spans.units]
    if None in clamped or None in binned or sum(binned) <= 0:
        return None
    return 100.0 * sum(clamped) / sum(binned)
