"""Peaks, the compositors' least work, and the model's FLOPs.

The peaks are NVIDIA's for one H100 SXM (data sheet, dense): float32
outside the tensor cores, since the program runs with TF32 off, and HBM3
bandwidth. A card set below its 700 W limit runs slower; the harness
prints the limit beside every number.

``kernel_bound`` / ``bwd_bound``: the least time the forward and backward
compositors need on the arrays one call binned: each walked instance row
read once (64 bytes), the outputs written once, against the float32
operations each walked (instance, pixel) pair needs, at peak.

``model_flops``: every conv3d, transposed conv3d and dense layer of the
U-Nets that run, with their bottleneck, and the Gaussian head at the
selected count, two FLOPs a multiply-add. A forward counts as the model
runs it; a backward counts, for each layer the loss reaches, the weight
gradient (as many FLOPs as its forward) and the input gradient (as many
again) unless the layer's input needs none. Nothing recomputed is counted.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

from benchmark.reference.model import Spec, layers

PEAK_FP32 = 67e12   # FLOP/s, H100 SXM, float32 without tensor cores
PEAK_BYTES = 3.35e12  # B/s, HBM3

# Least float32 operations a (instance, pixel) pair, an FMA two and expf
# one: dx, dy (2); the quadratic form with per-row coefficients (7); expf
# and the opacity (2); contrib = a*T (1); the rgb and alpha sums (7);
# T -= contrib (1).
OPS_PER_PAIR = 20
# The backward: a and T again (13), w = <g_rgb, rgb> + g_alpha (6), the
# suffix (2), dL/da (3), the colour gradients (6), the opacity's (2), the
# chain into the quadratic form (1), its coefficients' gradients (8), the
# mean's (8).
OPS_PER_PAIR_BWD = 49

# The device operations of one compositor call, by kernel name (the
# program's ``csrc/composite_fwd.cu`` / ``composite_bwd.cu`` and their
# shared chunk map), with the memsets and fills that a call launches.
KERNELS = {
    "composite_fwd": ("fwd_products", "fwd_scan", "fwd_contrib", "fwd_sum"),
    "composite_bwd": ("bwd_tot", "bwd_scan", "bwd_grad"),
}
SHARED_KERNELS = ("build_chunk_map",)


def _walked(counts, jstop, G: int) -> int:
    counts = counts.long()
    return int((counts.minimum(jstop.long() * G)).sum())


def kernel_bound(counts, jstop, tile_shape: Tuple[int, int], G: int) -> Dict:
    """Least seconds for a forward call: rows walked read once, per-tile
    scalars and rgb, alpha written once; OPS_PER_PAIR a walked pair."""
    P = tile_shape[0] * tile_shape[1]
    walked = _walked(counts, jstop, G)
    T = counts.numel()
    nbytes = walked * 64 + T * (4 + 4 + 8) + T * P * 16 + T * 4
    ops = walked * P * OPS_PER_PAIR
    return dict(bytes=nbytes, ops=ops,
                seconds=max(nbytes / PEAK_BYTES, ops / PEAK_FP32))


def bwd_bound(n_rows: int, counts, jstop, tile_shape: Tuple[int, int],
              G: int) -> Dict:
    """Least seconds for a backward call: walked rows and their chunks'
    entry transmittances read once, the pixel gradients and per-tile
    scalars read once, the instance-gradient array written once;
    OPS_PER_PAIR_BWD a walked pair."""
    P = tile_shape[0] * tile_shape[1]
    walked = _walked(counts, jstop, G)
    chunks = int(jstop.long().sum())
    T = counts.numel()
    nbytes = walked * 64 + chunks * P * 4 + T * P * 16 + T * 20 + n_rows * 64
    ops = walked * P * OPS_PER_PAIR_BWD
    return dict(bytes=nbytes, ops=ops,
                seconds=max(nbytes / PEAK_BYTES, ops / PEAK_FP32))


def _layer_flops(kind: str, shape, vox: int) -> int:
    """Forward FLOPs of one layer whose output has ``vox`` voxels (dense:
    one row)."""
    if kind == "conv":
        return 2 * math.prod(shape) * vox
    if kind == "tconv":
        return 2 * math.prod(shape) * (vox // 8)
    if kind == "dense":
        return 2 * math.prod(shape)
    return 0


def unet_layer_flops(spec: Spec, final: bool = True):
    """[(name, forward FLOPs)] of one U-Net at the crop, in order."""
    vox0 = math.prod(spec.crop)
    prefix = "final_unet." if final else "unets.0."
    out = []
    for name, kind, shape in layers(spec):
        if not name.startswith(prefix):
            continue
        local = name[len(prefix):]
        if local.startswith(("encoder", "decoder")):
            level = int(local[7])
            vox = vox0 // 8 ** (level - 1)
        elif local.startswith("upconv"):
            vox = vox0 // 8 ** (int(local[6]) - 1)
        else:
            vox = vox0
        out.append((local, _layer_flops(kind, shape, vox)))
    return out


def head_flops(spec: Spec) -> int:
    return 2 * spec.max_n * (spec.out_ch * 128 + 128 * spec.n_params)


def model_flops(spec: Spec, train: bool) -> int:
    """FLOPs of one train step (batch 1) or one eval frame.

    A U-Net whose output width equals its input width passes its input
    through: in eval its body does not run, in training it runs forward
    only, for its BN statistics. The final U-Net and the head run forward
    and, in training, backward; the final U-Net's first conv needs no
    input gradient (its input, the carve, has none)."""
    final = unet_layer_flops(spec, final=True)
    f_final = sum(f for _, f in final)
    f_head = head_flops(spec)
    if not train:
        return f_final + f_head
    f_pass = sum(f for _, f in unet_layer_flops(spec, final=False))
    first = final[0][1]
    backward = 2 * f_final - first + 2 * f_head
    return (spec.num_unets - 1) * f_pass + f_final + f_head + backward
