"""The chunk-parallel design of the compositor kernels, on the CPU.

The CUDA kernels (``csrc/composite_fwd.cu``, ``csrc/composite_bwd.cu``)
spread each tile's chunks over blocks of their own and carry T forward and
the suffix backward between them by per-pixel scans. A CUDA kernel cannot
run here, so this file holds the chunk → (tile, j) map (``chunk_map``, the
plain version of the kernels' phase 0), and a plain-torch rendition of
the kernels' phases built from that map, against
the one-walk-a-tile plain versions ``composite_instances_ref`` and
``composite_instances_bwd_ref``: the carries are the new logic.
"""

import numpy as np
import pytest
import torch

from pose_splatter_torch.ops import rasterize as tr
from pose_splatter_torch.ops import rasterize_kernels as tk

torch.set_num_threads(1)

TILE = (4, 8)  # P = 32 pixels: every array's size is a multiple of 32
G = 8
H, W = 24, 32  # 6 x 4 tiles a camera


def _walk(chunk_tile, n_chunks):
    """Each tile's chunks, in the map's order: {tile: [c, ...]}."""
    out = {}
    for c in range(n_chunks):
        t = int(chunk_tile[c])
        if t >= 0:
            out.setdefault(t, []).append(c)
    return out


def test_chunk_map_small_cases():
    """Tiles, G = 4, in a 40-row array: empty; one chunk (3 rows); 10 rows
    (3 chunks, the last ragged); 8 rows (2 whole chunks) after a padding
    chunk; empty with a start past the array; 12 rows cut to 8 at the
    array's end."""
    astarts = torch.tensor([0, 0, 4, 20, 44, 32], dtype=torch.int32)
    counts = torch.tensor([0, 3, 10, 8, 5, 12], dtype=torch.int32)
    tile, j, rows = tk.chunk_map(astarts, counts, 40, 4)
    assert tile.dtype == j.dtype == rows.dtype == torch.int32
    assert rows.tolist() == [0, 3, 10, 8, 0, 8]
    assert tile.tolist() == [1, 2, 2, 2, -1, 3, 3, -1, 5, 5]
    assert j.tolist() == [0, 0, 1, 2, -1, 0, 1, -1, 0, 1]


def test_chunk_map_of_binned_cameras():
    """On the binning's own arrays (three cameras in one array): every
    chunk of every tile appears once, in order, at its tile's rows; every
    other chunk maps to none."""
    rng = np.random.default_rng(4)
    n, views = 150, 3
    center = torch.from_numpy(np.stack(
        [rng.uniform(-4, 20, (views, n)), rng.uniform(-4, 16, (views, n))],
        -1).astype(np.float32))  # the right and bottom tiles stay empty
    radius = torch.from_numpy(rng.uniform(0.5, 5, (views, n)).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=(views, n)) < 0.9)
    packed = torch.zeros((views, n, tk.F))
    b = tr.bin_instances(packed, center, radius, valid, H, W, TILE, G, 16)
    R = b.inst.shape[0]
    tile, j, rows = tk.chunk_map(b.astarts, b.counts, R, G)
    assert torch.equal(rows, b.counts)  # the binning keeps segments inside
    seen = _walk(tile, R // G)
    for t in range(b.counts.numel()):
        n_steps = (int(b.counts[t]) + G - 1) // G
        first = int(b.astarts[t]) // G
        want = list(range(first, first + n_steps))
        assert seen.get(t, []) == want
        assert [int(j[c]) for c in want] == list(range(n_steps))
    assert (b.counts == 0).any() and (b.counts % G != 0).any()
    assert ((b.counts > 0) & (b.counts <= G)).any()  # one-chunk tiles
    padding = tile < 0
    assert padding.any() and (j[padding] == -1).all()
    assert int((~padding).sum()) == int(((b.counts + G - 1) // G).sum())


# ----------------------------------------------------------------------------
# The kernels' phases, rendered in plain torch from the chunk map.
# ----------------------------------------------------------------------------

def _chunks(inst, counts_rows, chunk_tile, chunk_j, origins, mode, cs):
    """Rows f [C,G,16], row mask [C,G], alpha and its aux for chunks cs."""
    t = chunk_tile[cs].long()
    rowmask = (torch.arange(G)[None, :]
               < (counts_rows[t] - chunk_j[cs].long() * G)[:, None])
    rows = cs[:, None] * G + torch.arange(G)[None, :]
    f = inst[torch.where(rowmask, rows, torch.zeros_like(rows))]
    xs, ys = tk._pixels(origins, TILE, mode, inst.device)
    a, aux = tk._chunk_alpha(mode, f, xs[t, None, :], ys[t, None, :],
                             rowmask[..., None])
    return t, f, rowmask, a, aux


def split_forward(inst, astarts, counts, origins, mode):
    """Products, scan, contributions, sum: rgb, alpha, jstop, tbounds."""
    R = inst.shape[0]
    nc, nt, P = R // G, counts.numel(), TILE[0] * TILE[1]
    chunk_tile, chunk_j, rows = tk.chunk_map(astarts, counts, R, G)
    rows = rows.long()
    mapped = torch.nonzero(chunk_tile >= 0).reshape(-1)
    # 1. products, one chunk at a time in any order
    t, f, rowmask, a, _ = _chunks(inst, rows, chunk_tile, chunk_j, origins,
                                  mode, mapped)
    cp = torch.full((nc, P), float("nan"))
    cp[mapped] = torch.cumprod(1.0 - a, dim=1)[:, -1]
    # 2. scan, each tile's chunks in order
    n_steps = (rows + G - 1) // G
    first = astarts.long() // G
    t_in = torch.ones((nt, P))
    tbounds = torch.zeros((nc, P))
    jstop = torch.zeros(nt, dtype=torch.int32)
    live = n_steps > 0
    for j in range(int(n_steps.max())):
        act = torch.nonzero(live & (n_steps > j)).reshape(-1)
        c = first[act] + j
        tbounds[c] = t_in[act]
        t_in[act] = t_in[act] * cp[c]
        jstop[act] = j + 1
        if mode == "conic":
            live[act] = t_in[act].amax(dim=1) >= tk.STOP_T
    # 3. contributions of the walked chunks
    walked = chunk_j[mapped].long() < jstop[t].long()
    cs, t, f, a = mapped[walked], t[walked], f[walked], a[walked]
    cprod = torch.cumprod(1.0 - a, dim=1)
    T = tbounds[cs][:, None, :] * torch.cat(
        [torch.ones_like(cprod[:, :1]), cprod[:, :-1]], dim=1)
    contrib = a * T
    if mode == "conic":
        contrib = torch.where(T * (1.0 - a) >= tk.STOP_T, contrib,
                              torch.zeros_like(contrib))
    part = torch.full((nc, 4, P), float("nan"))
    part[cs] = torch.stack([
        (contrib * f[..., 7:8]).sum(1), (contrib * f[..., 8:9]).sum(1),
        (contrib * f[..., 9:10]).sum(1), contrib.sum(1)], dim=1)
    # 4. sum, each tile's partials in chunk order
    acc = torch.zeros((nt, 4, P))
    for j in range(int(jstop.max())):
        act = torch.nonzero(jstop > j).reshape(-1)
        acc[act] += part[first[act] + j]
    return acc[:, :3], acc[:, 3], jstop, tbounds


def split_backward(inst, tbounds, astarts, counts, origins, jstop, g_rgb,
                   g_alpha, mode):
    """Pass 1, reverse scan, pass 2: dinst."""
    R = inst.shape[0]
    nc, nt, P = R // G, counts.numel(), TILE[0] * TILE[1]
    chunk_tile, chunk_j, rows = tk.chunk_map(astarts, counts, R, G)
    rows = rows.long()
    walked_n = torch.minimum(jstop.long(), (rows + G - 1) // G)
    mapped = torch.nonzero(chunk_tile >= 0).reshape(-1)
    keep_c = chunk_j[mapped].long() < walked_n[chunk_tile[mapped].long()]
    cs = mapped[keep_c]
    t, f, rowmask, a, aux = _chunks(inst, rows, chunk_tile, chunk_j, origins,
                                    mode, cs)
    cprod = torch.cumprod(1.0 - a, dim=1)
    T = tbounds[cs][:, None, :] * torch.cat(
        [torch.ones_like(cprod[:, :1]), cprod[:, :-1]], dim=1)
    keep = ((T * (1.0 - a) >= tk.STOP_T).float() if mode == "conic"
            else torch.ones_like(a))
    contrib = a * T * keep
    g_r, g_g, g_b = (g_rgb[t, c, None, :] for c in range(3))
    g_a = g_alpha[t, None, :]
    w = g_r * f[..., 7:8] + g_g * f[..., 8:9] + g_b * f[..., 9:10] + g_a
    wc = w * contrib
    # 1. each walked chunk's total
    tot = torch.full((nc, P), float("nan"))
    tot[cs] = wc.sum(1)
    # 2. reverse scan: the suffix each chunk carries in
    sfx = torch.full((nc, P), float("nan"))
    s = torch.zeros((nt, P))
    first = astarts.long() // G
    for jj in range(int(walked_n.max())):
        act = torch.nonzero(walked_n > jj).reshape(-1)
        c = first[act] + walked_n[act] - 1 - jj
        sfx[c] = s[act]
        s[act] += tot[c]
    # 3. each row's gradients from sfx + (tot - inclusive sum)
    s_i = sfx[cs][:, None, :] + (tot[cs][:, None, :] - torch.cumsum(wc, dim=1))
    da = w * T * keep - s_i / (1.0 - a)
    dcol = [(g * contrib).sum(2) for g in (g_r, g_g, g_b)]
    if mode == "conic":
        dx, dy, e, raw, flow = aux
        dsigma = -raw * (da * flow.float())
        A, B, C = f[..., 2:3], f[..., 3:4], f[..., 4:5]
        grads = [
            (-(A * dx + B * dy) * dsigma).sum(2),
            (-(C * dy + B * dx) * dsigma).sum(2),
            (0.5 * dx * dx * dsigma).sum(2), (dx * dy * dsigma).sum(2),
            (0.5 * dy * dy * dsigma).sum(2), torch.zeros_like(dcol[0]),
            (e * da * flow.float()).sum(2)]
    else:
        dx, dy, u, v, e, sx2, sy2 = aux
        da_m = da * rowmask[..., None].float()
        dE = f[..., 6:7] * da_m
        du = dE * (e * (-2.0 * u / sx2))
        dv = dE * (e * (-2.0 * v / sy2))
        c_, s_ = f[..., 2:3], f[..., 3:4]
        grads = [
            (-(du * c_ - dv * s_)).sum(2), (-(du * s_ + dv * c_)).sum(2),
            (du * dx + dv * dy).sum(2), (du * dy - dv * dx).sum(2),
            (dE * e * (u * u / (sx2 * sx2))).sum(2) * 4.0 * f[..., 4],
            (dE * e * (v * v / (sy2 * sy2))).sum(2) * 4.0 * f[..., 5],
            (e * da_m).sum(2)]
    grads = torch.stack(grads + dcol, dim=-1)  # [C,G,10]
    dinst = torch.zeros_like(inst)
    rows_all = cs[:, None] * G + torch.arange(G)[None, :]
    dinst[rows_all[rowmask], :10] = grads[rowmask]
    return dinst


def _scene(mode, seed=0, n=700, views=2):
    """Two cameras; 60 % of the Gaussians in a tight cluster on one tile
    (segments of 40 chunks and more), the rest spread over the image. In
    conic mode they are opaque enough that the clustered tiles stop early,
    part-way along their segments."""
    rng = np.random.default_rng(seed)
    hot = rng.uniform(size=n) < 0.6
    cx = np.where(hot, rng.uniform(9, 15, (views, n)),
                  rng.uniform(-3, W + 3, (views, n)))
    cy = np.where(hot, rng.uniform(5, 7, (views, n)),
                  rng.uniform(-3, H + 3, (views, n)))
    means = torch.from_numpy(np.stack([cx, cy], -1).astype(np.float32))
    colors = torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32))
    colors = colors.expand(views, -1, -1)
    valid = torch.from_numpy(rng.uniform(size=(views, n)) < 0.95)
    if mode == "ellipse":
        scales = torch.from_numpy(rng.uniform(0.4, 1.2, (n, 2)).astype(np.float32))
        radius = 3.0 * scales.amax(1)
        theta = torch.from_numpy(rng.uniform(-3, 3, n).astype(np.float32))
        opac = torch.from_numpy(rng.uniform(0.05, 0.3, n).astype(np.float32))
        packed = tk.pack_ellipse(means, scales.expand(views, -1, -1),
                                 theta.expand(views, -1),
                                 opac.expand(views, -1), colors,
                                 radius.expand(views, -1))
    else:
        sig = torch.from_numpy(rng.uniform(0.6, 1.6, (n, 2)).astype(np.float32))
        th = torch.from_numpy(rng.uniform(-3, 3, n).astype(np.float32))
        c, s = torch.cos(th), torch.sin(th)
        ia, ib = 1 / sig[:, 0] ** 2, 1 / sig[:, 1] ** 2
        conic = torch.stack([c * c * ia + s * s * ib, c * s * (ia - ib),
                             s * s * ia + c * c * ib], -1)
        radius = 3.0 * sig.amax(1)
        opac = torch.from_numpy(rng.uniform(0.3, 0.9, n).astype(np.float32))
        packed = tk.pack_conic(means, conic.expand(views, -1, -1),
                               opac.expand(views, -1), colors,
                               radius.expand(views, -1))
    b = tr.bin_instances(packed, means, radius.expand(views, -1), valid, H, W,
                         TILE, G, 16)
    grads = (torch.from_numpy(rng.normal(0, 1, (b.counts.numel(), 3, 32))
                              .astype(np.float32)),
             torch.from_numpy(rng.normal(0, 1, (b.counts.numel(), 32))
                              .astype(np.float32)))
    return (b.inst, b.astarts, b.counts, b.origins), grads


@pytest.mark.parametrize("mode", ["ellipse", "conic"])
def test_split_phases_match_the_single_walk(mode):
    (inst, astarts, counts, origins), (g_rgb, g_alpha) = _scene(mode)
    n_steps = (counts.long() + G - 1) // G
    assert int(n_steps.max()) >= 40  # the hot tile's long segment
    ref = tk.composite_instances_ref(inst, astarts, counts, origins, TILE, G,
                                     mode, save_tbounds=True)
    got = split_forward(inst, astarts, counts, origins, mode)
    assert torch.equal(got[2], ref[2])  # jstop
    assert torch.equal(got[3], ref[3])  # tbounds, bit for bit
    torch.testing.assert_close(got[0], ref[0], atol=1e-6, rtol=0)
    torch.testing.assert_close(got[1], ref[1], atol=1e-6, rtol=0)
    jstop = ref[2].long()
    if mode == "conic":  # a tile stopped part-way along its segment
        assert ((jstop > 1) & (jstop < n_steps - 1)).any()
    else:
        assert torch.equal(jstop, n_steps)
    d_ref = tk.composite_instances_bwd_ref(inst, ref[3], astarts, counts,
                                           origins, ref[2], g_rgb, g_alpha,
                                           TILE, G, mode)
    d = split_backward(inst, ref[3], astarts, counts, origins, ref[2], g_rgb,
                       g_alpha, mode)
    scale = d_ref.abs().amax(dim=0).clamp_min(1e-30)
    assert float(d_ref.abs().max()) > 0
    assert ((d - d_ref).abs() <= 1e-6 * scale).all(), (
        ((d - d_ref).abs() / scale).amax(dim=0))


def test_scratch_bytes_counts_the_kernels_scratch():
    """The forward's cp and partial sums (5 P floats a chunk), the
    backward's tot and sfx (2 P), and the map's two int32 a chunk and one
    a tile."""
    assert tk.scratch_bytes(640, 3, 64, (8, 128)) == (
        10 * (8 + 5 * 1024 * 4) + 12)
    assert tk.scratch_bytes(640, 3, 64, (8, 128), backward=True) == (
        10 * (8 + 2 * 1024 * 4) + 12)
