"""The roofline and FLOP arithmetic of ``benchmark/counts.py`` against
counts made by hand."""

import json
import math

import pytest
import torch

from benchmark import counts
from benchmark.reference.model import Spec

CROP_VOX = 96 * 80 * 64


def spec(name="a6000_2d"):
    from benchmark.harness import HERE
    return Spec(json.loads((HERE / "configs" / f"{name}.json").read_text()))


def test_kernel_bound_by_hand():
    # Two tiles of (8, 128): 100 rows (2 chunks of 64), the second tile
    # stopped after its first chunk of 70 rows.
    cnt = torch.tensor([100, 70], dtype=torch.int32)
    jstop = torch.tensor([2, 1], dtype=torch.int32)
    b = counts.kernel_bound(cnt, jstop, (8, 128), 64)
    walked = 100 + 64
    assert b["ops"] == walked * 1024 * 20
    assert b["bytes"] == walked * 64 + 2 * 16 + 2 * 1024 * 16 + 2 * 4
    assert b["seconds"] == max(b["ops"] / 67e12, b["bytes"] / 3.35e12)


def test_bwd_bound_by_hand():
    cnt = torch.tensor([100, 0, 5], dtype=torch.int32)
    jstop = torch.tensor([2, 0, 1], dtype=torch.int32)
    b = counts.bwd_bound(256, cnt, jstop, (8, 128), 64)
    walked = 105
    assert b["ops"] == walked * 1024 * 49
    assert b["bytes"] == (walked * 64 + 3 * 1024 * 4 + 3 * 1024 * 16 + 3 * 20
                          + 256 * 64)


@pytest.mark.parametrize("layer, flops", [
    # encoder1: 4 -> 8 channels, 3x3x3, at the whole 96x80x64 crop.
    ("encoder1.conv0", 2 * 8 * 4 * 27 * CROP_VOX),
    ("encoder1.conv1", 2 * 8 * 8 * 27 * CROP_VOX),
    # encoder2 at an eighth of the voxels, 8 -> 16.
    ("encoder2.conv0", 2 * 16 * 8 * 27 * CROP_VOX // 8),
    # upconv4: 128 -> 64, 2x2x2 stride 2, from 6x5x4 to 12x10x8.
    ("upconv4", 2 * 128 * 64 * 8 * (6 * 5 * 4)),
    # the bottleneck's first dense layer: 128 * 120 -> 512.
    ("mlp_1a", 2 * 128 * 120 * 512),
    ("final_conv", 2 * 8 * 8 * CROP_VOX),
])
def test_unet_layers_by_hand(layer, flops):
    got = dict(counts.unet_layer_flops(spec()))
    assert got[layer] == flops


def test_model_flops_train_and_eval():
    s = spec()
    final = sum(f for _, f in counts.unet_layer_flops(s))
    passthrough = sum(f for _, f in counts.unet_layer_flops(s, final=False))
    head = 2 * 16000 * (8 * 128 + 128 * 9)
    first = 2 * 8 * 4 * 27 * CROP_VOX
    assert counts.head_flops(s) == head
    assert counts.model_flops(s, train=False) == final + head
    assert counts.model_flops(s, train=True) == (
        2 * passthrough + final + head + 2 * final - first + 2 * head)
    # The 3D head has 14 outputs a Gaussian.
    assert counts.head_flops(spec("rtx3060_3d")) == 2 * 16000 * (8 * 128 + 128 * 14)


def test_flops_cover_every_weighted_layer():
    s = spec()
    names = [n for n, _ in counts.unet_layer_flops(s)]
    assert len(names) == 5 * 4 + 3 + 4 + 4 * 4 + 1  # blocks' convs+BNs, mlps, upconvs, final
    assert all(f > 0 for n, f in counts.unet_layer_flops(s) if ".bn" not in n)
    assert math.isclose(counts.model_flops(s, True) / 1e9, 73.41064192)
