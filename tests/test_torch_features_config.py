"""The visual-pose feature stage as the benchmark runs it
(``benchmark/configs/rtx3060_3d_features.json``), on the CPU: the file
against ``configs/templates/tpu_3d.json`` plus its ``visual_features``
block, ResNet-18's parameters counted without allocating a weight, a small
cut of the cell (the 3D preset's model at a 64² image and a grid of 16, the
rig at L = 1) run by the program against the plain reference
(``benchmark/reference/features.py``) on seeded random weights, the rig's
caps on a scene that the default caps truncate, and the feature frame's
spans."""

import copy
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness, resnet
from benchmark.reference import features as reference
from pose_splatter_torch.models.resnet import ResNet18
from pose_splatter_torch.preprocess import visual_features as vf
from pose_splatter_torch.utils import stages

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CFG = json.loads((ROOT / "benchmark/configs/rtx3060_3d_features.json").read_text())
TEMPLATE = json.loads((ROOT / "configs/templates/tpu_3d.json").read_text())
WORKLOAD = json.loads((ROOT / "benchmark/workloads/features-rig.json").read_text())
BLOCK = CFG["visual_features"]
PARAMETERS = 11_176_512  # ResNet-18 without ``fc``
# The 3D preset's model cut to a 64^2 image and a 16^3 crop of a grid of
# 16; the rig at L = 1 (2 polar nodes x 4 azimuths = 8 views), its size and
# caps as configured.
SMALL = dict(image_width=64, image_height=64, image_downsample=1, grid_size=16,
             volume_idx=[[0, 16], [0, 16], [0, 16]], min_n=16, max_n=256)
# float32 features: the program's (the forward compositor's plain version,
# the module's convolutions) against the reference's (the benchmark's
# compositor, F.conv2d), on the same CPU, over the frame's largest feature.
FEAT_TOL = 1e-5


def test_config_is_the_template_with_the_rig():
    for key, value in TEMPLATE.items():
        assert CFG[key] == value, key
    assert (CFG["min_n"], CFG["max_n"], CFG["num_unets"], CFG["base_filters"]) == \
        (1024, 16_000, 3, 8)
    assert set(BLOCK) == set(vf.RIG_DEFAULTS)
    assert (BLOCK["L"], BLOCK["size"], BLOCK["fov_deg"], BLOCK["radius"]) == \
        (3, 224, 7.5, 1.0)
    settings = vf.rig_settings(BLOCK)
    assert settings == BLOCK
    with pytest.raises(KeyError):
        vf.rig_settings(dict(BLOCK, tile_span=8))
    bench = harness.load_bench()
    entry = next(c for c in bench["configs"] if c["name"] == "rtx3060_3d_features")
    assert entry["reduced"] == [] and entry["file"].endswith("rtx3060_3d_features.json")
    # 32 views of 28 x 2 tiles of (8, 128) a 224-pixel view.
    assert 2 * (BLOCK["L"] + 1) ** 2 == 32
    assert math.ceil(BLOCK["size"] / 8) * math.ceil(BLOCK["size"] / 128) == 56


def test_resnet18_parameters_and_flops():
    with torch.device("meta"):
        net = ResNet18()
    assert all(p.is_meta for p in net.parameters())
    assert sum(p.numel() for p in net.parameters()) == PARAMETERS == resnet.parameters()
    # 1.814 GMAC an image at 224^2, as torchvision's resnet18 counts.
    assert resnet.flops(224) == 2 * 1_813_561_344
    weights = resnet.make_weights(5, "cpu")
    assert set(weights) == set(ResNet18().state_dict())


def test_rig_and_sh_matrix_as_described():
    """The reference's rig and SH matrix, built from the description,
    against the program's (``scipy`` spherical harmonics)."""
    for L in (1, 3):
        rig = reference.Rig(dict(BLOCK, L=L), "cpu")
        Ks, views, thetas, phis, w = vf.spherical_rig(L)
        np.testing.assert_allclose(rig.Ks.numpy(), Ks, rtol=1e-6)
        np.testing.assert_allclose(rig.Es.numpy(), views, rtol=0, atol=1e-6)
        A = vf.build_A(L, w, thetas, phis)
        np.testing.assert_allclose(rig.A_re.numpy(), A.real, rtol=0, atol=1e-6)
        np.testing.assert_allclose(rig.A_im.numpy(), A.imag, rtol=0, atol=1e-6)


def test_configured_caps_keep_what_the_default_caps_drop():
    """A small 3D model whose Gaussians all have a sigma of 6 mm (31 px on
    the rig) over an animal larger than the view: at L = 1 the defaults
    (16 tiles a Gaussian, 4N + T*G rows a camera) clamp the Gaussians that
    straddle the rig's two tile columns (18 tiles) and drop rows, and the
    counts say so; the configuration's caps clamp and drop none."""
    from pose_splatter_torch.models.pose_splatter import PoseSplatter
    from pose_splatter_torch.utils.geometry import create_3d_grid
    from pose_splatter_torch.utils.synthetic import ring_cameras, synthetic_frames

    kw = dict(ell=0.3, grid_size=16, min_n=32, max_n=256, volume_idx=[[0, 16]] * 3,
              num_unets=2, base_filters=4, gaussian_mode="3d", holdout_views=[1],
              volume_fill_color=0.38)
    Ks, Es = ring_cameras(3, 32, 32, focal=60.0, radius=0.6)
    model = PoseSplatter(Ks, Es, 32, 32, render_mode="kernel", device="cpu", **kw)
    with torch.no_grad():
        model.net.head2.weight.zero_()
        model.net.head2.bias.zero_()
        model.net.scale.fill_(math.log(0.006))
    grid = create_3d_grid(kw["ell"], kw["grid_size"], kw["volume_idx"])
    f = synthetic_frames(Ks, Es, 32, 32, grid.reshape(-1, 3).mean(0),
                         (0.09, 0.07, 0.06), n_frames=1, seed=0)
    obs = model.observed_views
    frame = (f["mask"][0, obs], f["img"][0, obs], f["p_3d"][0],
             np.float32(f["angle"][0]), np.float32(0.7))
    counts = {}
    for name, block in (("default", dict(L=1)), ("configured", dict(BLOCK, L=1))):
        fn = vf.make_frame_features(model, generator=torch.Generator().manual_seed(0),
                                    rig=block)
        with stages.trace("cpu"):
            fn(*frame)
        u = stages.last_trace().units[-1]
        counts[name] = (u["dropped_rows"], u["clamped_gaussians"], u["binned_gaussians"])
    dropped, clamped, binned = counts["default"]
    assert dropped > 0 and clamped > 0 and binned > 0
    assert counts["configured"] == (0, 0, binned)


def _cell(block):
    cfg = dict(copy.deepcopy(CFG), **SMALL)
    cfg["visual_features"] = block
    workload = dict(WORKLOAD, poses=2, warmup_frames=1)
    return harness.Cell(
        name="features-rig-small", chips=1, config=cfg, workload=workload,
        traffic=harness.Registry().module("traffic", workload["traffic"]),
        end_to_end=[], per_layer=[], readers={})


@pytest.fixture(scope="module")
def small_session():
    """Two frames of the small cut through the cell's own loop, the second
    one traced; then the kept frames' counts and the reference's."""
    cell = _cell(dict(BLOCK, L=1))
    session = cell.traffic.Session(cell, 2**31 + 43, "cpu")
    session.share = 1.0
    session.unit()
    with stages.trace("cpu"):
        session.unit()
    unit = stages.last_trace().units[-1]
    session.release()
    return session, unit


def test_small_cut_agrees_with_the_plain_reference(small_session):
    session, _ = small_session
    assert session.failed == 0 and session.attempted == 2 and len(session.kept) == 2
    ref = session.reference()
    for (_, _, got), want in zip(session.kept, ref):
        want = want.numpy()
        assert got.shape == want.shape == (4, 512) and got.dtype == np.float32
        scale = float(np.abs(want).max())
        assert scale > 0
        assert float(np.abs(got - want).max()) <= FEAT_TOL * scale
    checks = session.check()
    assert set(checks) == set(WORKLOAD["limits"]) == {"feat_gap", "rows_dropped",
                                                      "spans_clamped"}
    for name, c in checks.items():
        assert c["value"] <= c["limit"], (name, c)


def test_small_cut_renders_the_animal(small_session):
    """The rig's views show the Gaussians: the traced frame binned rows in
    every one of its 8 views' tiles it touched, none dropped."""
    _, unit = small_session
    assert unit["binning_calls"] == 1
    assert unit["binned_rows"] > 0 and unit["dropped_rows"] == 0
    assert unit["binned_gaussians"] > 0 and unit["clamped_gaussians"] == 0


def test_feature_frame_spans(small_session):
    """The frame is one unit under the root ``features``: the forward's
    stages, then ``resnet`` and ``sh``, each a child of the root."""
    _, unit = small_session
    spans = unit["spans"]
    assert unit["name"] == "features" and spans[0]["parent"] == -1
    children = [s["name"] for s in spans if s["parent"] == 0]
    for name in ("carve", "unets", "select_head", "binning", "kernel", "untile",
                 "resnet", "sh"):
        assert children.count(name) == 1, name
    assert children.index("resnet") < children.index("sh")
    assert unit["host_syncs"] >= 1  # the selection flag's read
