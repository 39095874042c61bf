"""Do the compositors compose under a batch of frames, with gradients?
Parity against per-frame ``"global"`` renders (counterpart of
``scripts/dbg_vmap_pallas.py``).

    python -m pose_splatter_torch.scripts.dbg_vmap_kernel
        [--device cuda|cpu] [--seed N] [--frames B] [--height H]
        [--width W] [--n N]

B = 3 frames of 2D Gaussians (64x128, N = 256 each, seed 0, the script's
draws in its order; sigma cutoff 30, a white background). The JAX script
``vmap``s ``rasterize_2d`` in ``"pallas"`` mode over the frames. The port
batches frames the way its train step does (``train/loop.py::_step``):
each frame's own kernel-mode render (one forward-compositor launch a
frame), the frames' losses Σrgb² + Σα²
summed, one backward (one backward-compositor launch a frame, the
gradients of every frame's inputs from it).

Held against each frame's ``"global"`` render (every Gaussian on every
pixel): the forward within atol 2e-5, the gradients of the summed loss
with respect to means, scales, rotations, opacities and colours within
atol 3e-4 / rtol 1e-3, the script's own tolerances. Prints ``batched fwd
parity OK`` and ``grad(batched) parity OK``, and raises AssertionError
on a mismatch (the process exits non-zero). On the CPU ``"kernel"`` mode
runs the compositors' plain versions.

The row cap. At sigma cutoff 30 every Gaussian's circle covers most of
the image's 8 tiles, about 1,800 instances a frame, past the binning's
default cap of 4·N + T·G = 1,536 rows: both packages drop and count 510
instances of frame 0 there (1,532 of the three frames), and the JAX
script's check fails against the JAX package as it now is (whose
``"pallas"`` render of frame 0, in interpret mode, the port's matches). So the parity runs bin with
the cap lifted to the worst case, N·expand + T·G rows (the JAX function's
``instance_cap``, ``rasterize.py::bin_instances`` here), and must drop
nothing; the first line renders through ``rasterize_2d`` at the default
cap and prints the overflow and its distance from ``"global"``.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from pose_splatter_torch.ops.rasterize import (
    DEFAULT_CHUNK,
    DEFAULT_TILE,
    _composite_instances,
    _tile_grid,
    rasterize_2d,
)
from pose_splatter_torch.ops.rasterize_kernels import DEFAULT_EXPAND, pack_ellipse
from pose_splatter_torch.scripts import probe_common as pc
from pose_splatter_torch.utils.device import card_line, resolve_device

H, W, N, B = 64, 128, 256, 3
SIGMA_CUTOFF = 30.0
FWD_ATOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 3e-4, 1e-3


def frames(B: int = B, H: int = H, W: int = W, N: int = N, seed: int = 0):
    """The script's inputs: means [B,N,2], scales [B,N,2], rotations
    [B,N], opacities [B,N], colours [B,N,3], float32."""
    rng = np.random.default_rng(seed)
    return tuple(np.asarray(a, np.float32) for a in (
        rng.uniform(10, 110, (B, N, 2)), rng.uniform(1, 4, (B, N, 2)),
        rng.uniform(0, np.pi, (B, N)), rng.uniform(0.2, 0.9, (B, N)),
        rng.uniform(0, 1, (B, N, 3))))


def render(x, mode: str, H: int = H, W: int = W):
    """Each frame rendered on its own: rgb [B,H,W,3], alpha [B,H,W] and the
    instances dropped, summed over the frames. ``"kernel"`` bins with the
    row cap lifted (what ``rasterize_2d``'s kernel mode does, with
    ``instance_cap``), ``"default"`` is ``rasterize_2d``'s kernel mode as
    it is, ``"global"`` its oracle."""
    dev = x[0].device
    bg = torch.ones(3, device=dev)
    _, n_ty, n_tx = _tile_grid(H, W, DEFAULT_TILE)
    T = n_ty * n_tx
    outs, dropped = [], 0
    for b in range(x[0].shape[0]):
        means, scales, rot, opac, cols = (a[b] for a in x)
        if mode == "kernel":
            radius = SIGMA_CUTOFF * torch.maximum(scales[:, 0], scales[:, 1])
            packed = pack_ellipse(means, scales, rot, opac, cols, radius)
            valid = torch.ones(means.shape[0], dtype=torch.bool, device=dev)
            rgb, alpha, over = _composite_instances(
                packed[None], means[None], radius[None], valid[None],
                "ellipse", H, W, DEFAULT_TILE, DEFAULT_CHUNK, DEFAULT_EXPAND,
                instance_cap=means.shape[0] * DEFAULT_EXPAND + T * DEFAULT_CHUNK)
            rgb, alpha = rgb[0] + (1.0 - alpha[0][..., None]) * bg, alpha[0]
        else:
            rgb, alpha, over = rasterize_2d(
                means, scales, rot, opac, cols, W, H,
                mode="kernel" if mode == "default" else mode,
                sigma_cutoff=SIGMA_CUTOFF, background=bg, return_overflow=True)
        outs.append((rgb, alpha))
        dropped += int(over)
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]), dropped)


def grads(x, mode: str, H: int = H, W: int = W):
    """Gradients of Σ_frames (Σrgb² + Σα²) with respect to every input."""
    ps = [a.detach().requires_grad_() for a in x]
    rgb, alpha, _ = render(ps, mode, H, W)
    return torch.autograd.grad(pc.scalar_loss(rgb, alpha), ps)


def run(device="cuda", seed: int = 0, B: int = B, H: int = H, W: int = W,
        N: int = N) -> Dict:
    dev = resolve_device(device)
    card = card_line(dev)
    print(f"device: {card}", flush=True)
    x = tuple(torch.from_numpy(a).to(dev) for a in frames(B, H, W, N, seed))
    with torch.no_grad():
        rgb_g, al_g, _ = render(x, "global", H, W)
        rgb_d, _, dropped_default = render(x, "default", H, W)
        rgb_k, al_k, dropped = render(x, "kernel", H, W)
    default_err = float((rgb_d - rgb_g).abs().max())
    print(f"default row cap: {dropped_default} instances dropped in {B} "
          f"frames, max |rgb - global| {default_err:.3g}", flush=True)
    if dropped:
        raise AssertionError(f"{dropped} instances dropped at the lifted cap")
    fwd_err = max(float((rgb_k - rgb_g).abs().max()),
                  float((al_k - al_g).abs().max()))
    for got, ref in ((rgb_k, rgb_g), (al_k, al_g)):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   atol=FWD_ATOL)
    print("batched fwd parity OK", flush=True)
    g_k, g_g = grads(x, "kernel", H, W), grads(x, "global", H, W)
    grad_err = max(float((a - b).abs().max()) for a, b in zip(g_k, g_g))
    for a, b in zip(g_k, g_g):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL)
    print("grad(batched) parity OK", flush=True)
    return dict(card=card, device=str(dev), frames=B,
                dropped_default_cap=dropped_default,
                default_cap_max_abs_err=default_err,
                fwd_max_abs_err=fwd_err, grad_max_abs_err=grad_err,
                parity=True)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=B)
    ap.add_argument("--height", type=int, default=H)
    ap.add_argument("--width", type=int, default=W)
    ap.add_argument("--n", type=int, default=N)
    a = ap.parse_args(argv)
    return run(a.device, a.seed, a.frames, a.height, a.width, a.n)


if __name__ == "__main__":
    main()
