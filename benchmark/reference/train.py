"""Plain PyTorch losses, train steps and Adam of the reference.

The loss of a frame is soft IoU of the alpha against the target mask, plus
``img_lambda`` times the masked L1 of the colours and ``ssim_lambda`` times
(1 - SSIM), SSIM with an 11-tap Gaussian window (sigma 1.5), k1 0.01, k2
0.03, VALID filtering and a global mean. A step is the gradient of one
frame's loss by autograd and Adam (betas 0.9 and 0.999, eps 1e-8 outside
the square root, bias-corrected) on every parameter the loss reaches.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from benchmark.reference.model import Cameras, Params, Spec, forward, is_buffer


def _ssim(pred, target):
    coords = torch.arange(11, dtype=torch.float32, device=pred.device) - 5.0
    g = torch.exp(-(coords ** 2) / (2.0 * 1.5 ** 2))
    g = g / g.sum()
    k = torch.outer(g, g)[None, None].expand(3, 1, 11, 11).contiguous()

    def filt(x):
        return F.conv2d(x.permute(2, 0, 1)[None], k, groups=3)

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu_x, mu_y = filt(pred), filt(target)
    sxx = filt(pred * pred) - mu_x * mu_x
    syy = filt(target * target) - mu_y * mu_y
    sxy = filt(pred * target) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sxy + c2)
    den = (mu_x * mu_x + mu_y * mu_y + c1) * (sxx + syy + c2)
    return torch.mean(num / den)


def loss(rgb, alpha, target_img, target_mask, spec: Spec):
    inter = (alpha * target_mask).sum()
    union = (alpha + target_mask - alpha * target_mask).sum()
    l_iou = 1.0 - (inter + 1e-6) / (union + 1e-6)
    l_img = spec.img_lambda * (target_img - rgb).abs().sum() / torch.clamp(
        target_mask.sum(), min=1.0)
    l_ssim = spec.ssim_lambda * (1.0 - _ssim(rgb, target_img))
    return l_iou + l_ssim + l_img


def train_steps(weights: Params, spec: Spec, cams: Cameras, grid,
                steps: Sequence[Dict], lr: float) -> Dict:
    """Run ``steps`` (dicts of mask, img, p_3d, angle, view, obs) from
    ``weights``. Returns each step's loss, each leaf's first gradient norm
    (None where the loss does not reach it) and each leaf's change after
    the last step."""
    P = {k: v.detach().clone() for k, v in weights.items()}
    leaves = [k for k in P if not is_buffer(k)]
    m = {k: torch.zeros_like(P[k]) for k in leaves}
    v = {k: torch.zeros_like(P[k]) for k in leaves}
    losses: List[float] = []
    first: Dict[str, float] = {}
    for t, s in enumerate(steps, start=1):
        for k in leaves:
            P[k].requires_grad_(True)
        rgb, alpha, _ = forward(P, spec, cams, grid, s["mask"], s["img"],
                                s["p_3d"], s["angle"], s["view"], train=True)
        obs = s["obs"]
        value = loss(rgb, alpha, s["img"][obs], s["mask"][obs], spec)
        grads = torch.autograd.grad(value, [P[k] for k in leaves],
                                    allow_unused=True)
        losses.append(float(value.detach()))
        with torch.no_grad():
            for k, g in zip(leaves, grads):
                P[k] = P[k].detach()
                if t == 1:
                    first[k] = None if g is None else float(g.norm())
                if g is None:
                    continue
                m[k] = 0.9 * m[k] + 0.1 * g
                v[k] = 0.999 * v[k] + 0.001 * g * g
                mhat = m[k] / (1.0 - 0.9 ** t)
                vhat = v[k] / (1.0 - 0.999 ** t)
                P[k] = P[k] - lr * mhat / (torch.sqrt(vhat) + 1e-8)
        del grads, rgb, alpha, value
    change = {k: float((P[k] - weights[k]).norm()) for k in leaves}
    return dict(losses=losses, grad_norms=first, change_norms=change)


@torch.no_grad()
def render_frames(weights: Params, spec: Spec, cams: Cameras, grid,
                  frames: Sequence[Dict], view: int) -> List[torch.Tensor]:
    """The eval forward of each frame to ``view``: float rgb [H,W,3] each."""
    return [forward(weights, spec, cams, grid, f["mask"], f["img"], f["p_3d"],
                    f["angle"], view, train=False)[0] for f in frames]
