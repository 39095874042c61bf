"""The reference's high-resolution 2D preset as the benchmark runs it
(``benchmark/configs/a100_2d_highres.json``), on the CPU: the file against
``configs/templates/tpu_2d_highres.json``, its parameters counted at the
published widths without allocating a weight (the plain reference's
layer list and the program's net on the meta device), and a small cut of
its settings (view-anchored 2D, ``max_n`` above the model's default, the
1152:1024 aspect; crop and image scaled down) trained by the program
against the plain reference (``benchmark/reference/``) on seeded random
weights, with the limits of the preset's cell."""

import json
import math
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.reference.model import Spec, is_buffer, param_shapes
from pose_splatter_torch.config import Config
from pose_splatter_torch.models.pose_splatter import PoseSplatterNet
from pose_splatter_torch.utils import stages

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CFG = json.loads((ROOT / "benchmark/configs/a100_2d_highres.json").read_text())
TEMPLATE = json.loads((ROOT / "configs/templates/tpu_2d_highres.json").read_text())
WORKLOAD = json.loads((ROOT / "benchmark/workloads/train-2d-highres.json").read_text())
# The preset's parameters at its published widths: the template's model,
# built as written on the card, counts the same.
PARAMETERS = 382_889_602
# 9:8 as 1152x1024; a crop of 32^3 = 32,768 voxels, so that max_n can lie
# above the model's default of 16,000.
SMALL = dict(image_width=144, image_height=128, image_downsample=1,
             grid_size=64, volume_idx=[[8, 40], [16, 48], [16, 48]],
             max_n=20_000)


def test_config_is_the_template_view_anchored():
    for key, value in TEMPLATE.items():
        if key == "gaussian_config":
            assert CFG[key] == dict(value, view_anchored=True)
        else:
            assert CFG[key] == value, key
    config = Config(CFG)
    assert (config.render_width, config.render_height) == (1152, 1024)
    assert (CFG["min_n"], CFG["max_n"], CFG["num_unets"], CFG["base_filters"]) == \
        (1024, 128_000, 3, 8)
    bench = harness.load_bench()
    entry = next(c for c in bench["configs"] if c["name"] == "a100_2d_highres")
    assert entry["reduced"] == ["gaussian_config"]


def test_parameters_at_published_widths():
    spec = Spec(CFG)
    assert spec.crop == (192, 160, 128) and math.prod(spec.crop) == 3_932_160
    counted = sum(math.prod(s) for n, s in param_shapes(spec).items()
                  if not is_buffer(n))
    with torch.device("meta"):
        net = PoseSplatterNet(spec.in_ch, spec.out_ch, spec.bf, spec.num_unets,
                              input_size=spec.crop,
                              num_gaussian_params=spec.n_params)
    assert all(p.is_meta for p in net.parameters())
    assert counted == sum(p.numel() for p in net.parameters()) == PARAMETERS
    # The dense layers at the bottleneck (12x10x8 voxels of 128 channels)
    # hold nearly all of them: two of 122,880 x 512 a U-Net.
    width = 16 * spec.bf * math.prod(spec.ns)
    assert width == 122_880
    assert sum(p.numel() for n, p in net.named_parameters()
               if ".mlp_" in n) == 3 * (2 * width * 512 + 512 * 512 + width + 2 * 512)


@pytest.fixture(scope="module")
def small_session():
    cfg = dict(CFG, **SMALL)
    workload = dict(WORKLOAD, frames=4)
    cell = harness.Cell(
        name="train-2d-highres-small", chips=1, config=cfg, workload=workload,
        traffic=harness.Registry().module("traffic", workload["traffic"]),
        end_to_end=[], per_layer=[], readers={})
    session = cell.traffic.Session(cell, 2**31 + 41, "cpu")
    with stages.trace("cpu"):
        session.unit()
    unit = stages.last_trace().units[-1]
    session.release()
    return session, unit


def test_small_cut_agrees_with_the_plain_reference(small_session):
    session, _ = small_session
    assert session.failed == 0 and session.attempted == 1
    assert len(session.prog["losses"]) == WORKLOAD["checked_steps"]
    checks = session.check()
    assert set(checks) == set(WORKLOAD["limits"]) == {"loss_gap", "grad_gap", "step_gap"}
    for name, c in checks.items():
        assert c["value"] <= c["limit"], (name, c)


def test_small_cut_selects_in_the_window(small_session):
    """The scene's voxels above the final threshold lie between min_n and
    max_n, so every one of them is kept: not the starved regime, where
    more lie above it than max_n keeps (docs/DESIGN.md)."""
    _, unit = small_session
    assert unit["selection_calls"] == 1
    assert CFG["min_n"] <= unit["above_threshold"] == unit["gaussians_live"] < SMALL["max_n"]
    assert unit["dropped_rows"] == 0
