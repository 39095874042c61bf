"""The port's quaternion helpers and 3D Gaussian projection against the JAX
package: values, with radii and validity exactly equal, and gradients
against ``jax.vjp``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pose_splatter_tpu.ops import projection as jproj
from pose_splatter_tpu.utils import geometry as jgeo
from pose_splatter_torch.ops import projection as tproj
from pose_splatter_torch.utils import geometry as tgeo
from pose_splatter_torch.utils.synthetic import ring_cameras

torch.set_num_threads(1)

W, H = 96, 64


def _t(x, grad=False):
    return torch.from_numpy(np.array(x, np.float32)).requires_grad_(grad)


def _quats(rng, n):
    """Random quaternions kept away from w = 0 after a yaw of up to 0.6
    rad, where the w >= 0 sign flip makes the gradient jump."""
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[:, 0] = np.sign(q[:, 0]) * np.maximum(np.abs(q[:, 0]), 0.5)
    return (q * rng.uniform(0.5, 2.0, (n, 1))).astype(np.float32)


def test_quaternion_helpers_match():
    rng = np.random.default_rng(0)
    q1, q2 = _quats(rng, 50), _quats(rng, 50)
    pairs = [
        (jgeo.quat_normalize(jnp.asarray(q1)), tgeo.quat_normalize(_t(q1))),
        (jgeo.quat_multiply(jnp.asarray(q1), jnp.asarray(q2)),
         tgeo.quat_multiply(_t(q1), _t(q2))),
        (jgeo.quat_to_rotmat(jgeo.quat_normalize(jnp.asarray(q1))),
         tgeo.quat_to_rotmat(tgeo.quat_normalize(_t(q1)))),
        (jgeo.yaw_quat(jnp.float32(0.7)), tgeo.yaw_quat(0.7)),
        (jgeo.rotate_quats_by_yaw(jnp.asarray(q1), jnp.float32(-0.4)),
         tgeo.rotate_quats_by_yaw(_t(q1), torch.tensor(-0.4))),
    ]
    for ref, got in pairs:
        # Entries of magnitude up to 2; the norm's square root and sum
        # round differently: a few float32 ulps.
        np.testing.assert_allclose(np.asarray(ref), got.numpy(), rtol=0,
                                   atol=1e-6)
    out = pairs[-1][1]
    assert (out[:, 0] >= 0).all()  # the sign is canonical
    np.testing.assert_allclose(out.norm(dim=1).numpy(), 1.0, atol=1e-6)


def test_rotate_quats_by_yaw_gradient_matches():
    rng = np.random.default_rng(1)
    q = _quats(rng, 40)
    g = rng.normal(size=(40, 4)).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jgeo.rotate_quats_by_yaw(x, jnp.float32(0.6)),
                     jnp.asarray(q))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    qt = _t(q, grad=True)
    tgeo.rotate_quats_by_yaw(qt, torch.tensor(0.6)).backward(_t(g))
    np.testing.assert_allclose(ref, qt.grad.numpy(), rtol=0,
                               atol=1e-6 * np.abs(ref).max())


def _scene(n, seed):
    """Gaussians around the origin seen by ring cameras: most in view, some
    beyond the image edge, a few behind the near plane or the camera."""
    rng = np.random.default_rng(seed)
    means = rng.normal(0, 0.08, (n, 3)).astype(np.float32)
    means[:5] = rng.normal(0, 1.0, (5, 3))  # far off: culled or clamped
    Ks, Es = ring_cameras(3, W, H, focal=120.0, radius=0.6)
    cam = -Es[0, :3, :3].T @ Es[0, :3, 3]
    means[5] = cam  # at the camera centre: depth ~0
    means[6] = cam * 1.5  # behind the camera
    quats = _quats(rng, n)
    scales = np.exp(rng.normal(-4.0, 0.6, (n, 3))).astype(np.float32)
    return means, quats, scales, Ks, Es


@pytest.mark.parametrize("radius_clip", [0.0, 2.0])
def test_project_gaussians_matches(radius_clip):
    means, quats, scales, Ks, Es = _scene(300, 2)
    ref = jax.vmap(lambda v, k: jproj.project_gaussians(
        jnp.asarray(means), jnp.asarray(quats), jnp.asarray(scales), v, k, W,
        H, radius_clip=radius_clip))(jnp.asarray(Es), jnp.asarray(Ks))
    got = tproj.project_gaussians(_t(means), _t(quats), _t(scales), _t(Es),
                                  _t(Ks), W, H, radius_clip=radius_clip)
    # The ceil in the radius and the validity gates: equal, not close.
    np.testing.assert_array_equal(np.asarray(ref.radius), got.radius.numpy())
    np.testing.assert_array_equal(np.asarray(ref.valid), got.valid.numpy())
    ok = np.asarray(ref.valid)
    assert 0 < ok.sum() < ok.size  # some culled, most kept
    for name in ("mean2d", "conic", "depth"):
        r, g = np.asarray(getattr(ref, name))[ok], getattr(got, name).numpy()[ok]
        # The same expressions in the same order: float32 rounding only.
        np.testing.assert_allclose(r, g, rtol=2e-6, atol=1e-6, err_msg=name)
    # One camera alone gives the batch's row.
    one = tproj.project_gaussians(_t(means), _t(quats), _t(scales), _t(Es[1]),
                                  _t(Ks[1]), W, H, radius_clip=radius_clip)
    for a, b in zip(one, got):
        assert torch.equal(a, b[1])


def test_project_gaussians_gradients_match():
    means, quats, scales, Ks, Es = _scene(200, 3)
    rng = np.random.default_rng(4)
    cot = [rng.normal(size=s).astype(np.float32)
           for s in ((3, 200, 2), (3, 200, 3), (3, 200))]

    def jf(m, q, s):
        p = jax.vmap(lambda v, k: jproj.project_gaussians(m, q, s, v, k, W, H))(
            jnp.asarray(Es), jnp.asarray(Ks))
        return p.mean2d, p.conic, p.depth, p.valid

    out, vjp = jax.vjp(lambda m, q, s: jf(m, q, s)[:3], jnp.asarray(means),
                       jnp.asarray(quats), jnp.asarray(scales))
    valid = np.asarray(jf(jnp.asarray(means), jnp.asarray(quats),
                          jnp.asarray(scales))[3])
    # Culled rows' values are never used downstream; keep them out.
    cot = [c * valid[..., None] if c.ndim == 3 else c * valid for c in cot]
    ref = vjp(tuple(jnp.asarray(c) for c in cot))
    args = [_t(x, grad=True) for x in (means, quats, scales)]
    p = tproj.project_gaussians(*args, _t(Es), _t(Ks), W, H)
    torch.autograd.backward([p.mean2d, p.conic, p.depth], [_t(c) for c in cot])
    for name, r, a in zip(("means", "quats", "scales"), ref, args):
        r = np.asarray(r)
        np.testing.assert_allclose(r, a.grad.numpy(), rtol=0,
                                   atol=1e-4 * np.abs(r).max(), err_msg=name)


def test_quat_scale_to_covar_matches():
    rng = np.random.default_rng(5)
    q, s = _quats(rng, 30), np.exp(rng.normal(-3, 0.5, (30, 3))).astype(np.float32)
    ref = jproj.quat_scale_to_covar(jnp.asarray(q), jnp.asarray(s))
    got = tproj.quat_scale_to_covar(_t(q), _t(s))
    # Products of rotation entries summed over 3 terms: within 1e-6 of each
    # matrix's largest entry (off-diagonal entries cancel).
    ref = np.asarray(ref)
    scale = np.abs(ref).max(axis=(1, 2), keepdims=True)
    assert (np.abs(ref - got.numpy()) <= 1e-6 * scale).all()
