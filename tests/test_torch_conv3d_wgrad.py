"""The 3×3×3 convolutions' weight-gradient route (``ops/conv3d.py``) on the
CPU: the plain version against ``torch.nn.grad.conv3d_weight`` in float64,
the route's rule at the final U-Net's 23 convs at both crops, the kernel's
split of the positions, the autograd function's gradients, the CPU path of
``ConvBlock`` unchanged bit for bit, the wrapper's checks and the probe at
a small size. The kernel itself runs only on the card
(``test_torch_cuda_kernels.py``)."""

import pytest
import torch
import torch.nn.functional as F

from pose_splatter_torch.models.unet3d import ConvBlock
from pose_splatter_torch.ops import conv3d
from pose_splatter_torch.scripts import dbg_conv_wgrad_micro as probe

torch.set_num_threads(1)

# (Cin, Cout) of every conv the rule routes at the two crops.
ROUTED_CHANNELS = [(4, 8), (8, 8), (8, 16), (16, 16), (16, 32), (32, 32),
                   (32, 64), (64, 64), (64, 32), (32, 16), (16, 8)]
# (D, H, W): small, ragged (odd W, D not a multiple of anything) and flat.
EXTENTS = [(4, 6, 8), (3, 5, 7), (1, 4, 4), (5, 3, 2)]


@pytest.mark.parametrize("extent", EXTENTS)
@pytest.mark.parametrize("cin,cout", ROUTED_CHANNELS)
def test_plain_version_matches_torch(cin, cout, extent):
    gen = torch.Generator().manual_seed(cin * 100 + cout)
    x = torch.randn(1, cin, *extent, generator=gen, dtype=torch.float64)
    gy = torch.randn(1, cout, *extent, generator=gen, dtype=torch.float64)
    gw, gb = conv3d.conv3d_weight_grad_ref(x, gy)
    want = torch.nn.grad.conv3d_weight(x, (cout, cin, 3, 3, 3), gy, padding=1)
    torch.testing.assert_close(gw, want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(gb, gy.sum((0, 2, 3, 4)), rtol=1e-12,
                               atol=1e-12)


# The rule's choice for each conv of Unet3D(4, 8, 8), in module order:
# (routed at 96×80×64, routed at 192×160×128). Every 3×3×3 conv of the
# three finest levels; at 192×160×128 the fourth level's too, but 128→64.
RULE = [("encoder1.conv0", 1, 1), ("encoder1.conv1", 1, 1),
        ("encoder2.conv0", 1, 1), ("encoder2.conv1", 1, 1),
        ("encoder3.conv0", 1, 1), ("encoder3.conv1", 1, 1),
        ("encoder4.conv0", 0, 1), ("encoder4.conv1", 0, 1),
        ("encoder5.conv0", 0, 0), ("encoder5.conv1", 0, 0),
        ("upconv4", 0, 0), ("decoder4.conv0", 0, 0), ("decoder4.conv1", 0, 1),
        ("upconv3", 0, 0), ("decoder3.conv0", 1, 1), ("decoder3.conv1", 1, 1),
        ("upconv2", 0, 0), ("decoder2.conv0", 1, 1), ("decoder2.conv1", 1, 1),
        ("upconv1", 0, 0), ("decoder1.conv0", 1, 1), ("decoder1.conv1", 1, 1),
        ("final_conv", 0, 0)]
NAMES = [name for name, _, _ in RULE]
CROPS = [(96, 80, 64), (192, 160, 128)]


@pytest.mark.parametrize("at", [0, 1])
def test_rule_at_the_final_unets_convs(at):
    rows = probe.unet_convs(CROPS[at])
    assert [r["name"] for r in rows] == NAMES
    assert [int(r["routed"]) for r in rows] == [e[1 + at] for e in RULE]
    assert sum(e[1 + at] for e in RULE) == (12, 15)[at]
    for r in rows:
        if r["routed"]:
            assert probe.kernel_can_take(r)


def test_rule_reads_the_shape_alone():
    w = (8, 16, 3, 3, 3)
    assert conv3d.takes((1, 16, 96, 80, 64), w)
    assert not conv3d.takes((2, 16, 96, 80, 64), w)              # batch
    assert not conv3d.takes((1, 16, 96, 80, 60), w)              # W
    assert not conv3d.takes((1, 16, 4, 4, 64), w)                # positions
    assert not conv3d.takes((1, 16, 96, 80, 64), (6, 16, 3, 3, 3))  # Cout
    assert not conv3d.takes((1, 16, 96, 80, 64), (8, 16, 1, 1, 1))
    assert not conv3d.takes((1, 16, 96, 80, 64), w, stride=(2, 2, 2))
    assert not conv3d.takes((1, 16, 96, 80, 64), w, padding=(0, 0, 0))
    assert not conv3d.takes((1, 16, 96, 80, 64), w, groups=2)
    assert not conv3d.takes((1, 128, 24, 20, 16), (64, 128, 3, 3, 3))
    # The kernel fits where only the rule's thresholds say no.
    assert conv3d.fits((1, 16, 4, 4, 64), w)
    assert conv3d.fits((1, 128, 24, 20, 16), (64, 128, 3, 3, 3))
    assert not conv3d.fits((1, 16, 96, 80, 60), w)


@pytest.mark.parametrize("crop", CROPS)
def test_split_covers_every_step_in_one_wave(crop):
    for r in probe.unet_convs(crop):
        if not r["routed"]:
            continue
        _, cin, D, H, W = r["x"]
        cout = r["y"][1]
        per, chunks = conv3d.split(cin, cout, D, H, W)
        steps = D * -(-H // (128 // W))
        pair_blocks = -(-(cout // 4) * cin // 4)
        assert per * chunks >= steps > per * (chunks - 1)
        assert chunks == 1 or chunks * pair_blocks <= conv3d.RESIDENT_BLOCKS
        assert chunks <= 65535


@pytest.mark.parametrize("needs_x", [True, False])
def test_autograd_function_on_the_cpu(needs_x):
    """``Conv3dWeightGrad`` on CPU tensors (the route never takes it there;
    its plumbing is what is held): the forward equals ``F.conv3d`` bit for
    bit, the gradients equal autograd's through ``F.conv3d`` in float64,
    and no input gradient is computed where none is asked for."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 4, 3, 5, 8, generator=gen, dtype=torch.float64)
    w = torch.randn(8, 4, 3, 3, 3, generator=gen, dtype=torch.float64)
    b = torch.randn(8, generator=gen, dtype=torch.float64)
    gy = torch.randn(1, 8, 3, 5, 8, generator=gen, dtype=torch.float64)
    grads = []
    for fn in (conv3d.Conv3dWeightGrad.apply,
               lambda *a: F.conv3d(*a, padding=1)):
        leaves = [t.clone().requires_grad_(r)
                  for t, r in ((x, needs_x), (w, True), (b, True))]
        y = fn(*leaves)
        y.backward(gy)
        grads.append((y.detach(), [t.grad for t in leaves]))
    (y0, g0), (y1, g1) = grads
    assert torch.equal(y0, y1)
    assert (g0[0] is None) == (not needs_x)
    for a, b_ in zip(g0, g1):
        if a is not None:
            torch.testing.assert_close(a, b_, rtol=1e-12, atol=1e-12)


def test_conv_block_on_the_cpu_is_unchanged(monkeypatch):
    """On the CPU the route keeps the module's own convolution (the
    autograd function is never applied), so a ``ConvBlock``'s train-mode
    forward and backward equal, bit for bit, the block written with
    ``self.conv0(x)`` and ``self.conv1(x)``."""
    def refused(*a):
        raise AssertionError("Conv3dWeightGrad applied on the CPU")

    monkeypatch.setattr(conv3d.Conv3dWeightGrad, "apply", refused)
    torch.manual_seed(0)
    block = ConvBlock(8, 16)
    x = torch.randn(1, 8, 16, 16, 16)
    gy = torch.randn(1, 16, 16, 16, 16)

    def plain(x):
        h = F.leaky_relu(block.bn0(block.conv0(x), {}), block.negative_slope)
        return F.leaky_relu(block.bn1(block.conv1(h), {}),
                            block.negative_slope)

    outs = []
    for fn in (lambda x: block(x, {}), plain):
        block.zero_grad(set_to_none=True)
        xi = x.clone().requires_grad_(True)
        y = fn(xi)
        y.backward(gy)
        outs.append([y.detach(), xi.grad]
                    + [p.grad.clone() for p in block.parameters()])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_route_keeps_the_module_off_the_card_and_without_grad():
    conv = torch.nn.Conv3d(4, 8, 3, padding=1)
    x = torch.randn(1, 4, 96, 80, 64)
    assert conv3d.takes(x.shape, conv.weight.shape)
    y = conv3d.conv3d(conv, x)
    assert type(y.grad_fn).__name__ == "ConvolutionBackward0"
    with torch.no_grad():
        assert conv3d.conv3d(conv, x).grad_fn is None


def test_wrapper_checks_and_plain_path():
    x = torch.randn(1, 4, 3, 4, 8)
    gy = torch.randn(1, 8, 3, 4, 8)
    before = conv3d.conv3d_weight_grad.launches
    gw, gb = conv3d.conv3d_weight_grad(x, gy)
    assert conv3d.conv3d_weight_grad.launches == before  # no kernel here
    ref = conv3d.conv3d_weight_grad_ref(x, gy)
    assert torch.equal(gw, ref[0]) and torch.equal(gb, ref[1])
    assert gw.shape == (8, 4, 3, 3, 3) and gb.shape == (8,)
    with pytest.raises(ValueError, match="must be"):
        conv3d.conv3d_weight_grad(x[0], gy)
    with pytest.raises(ValueError, match="differ"):
        conv3d.conv3d_weight_grad(x, gy[..., :4])
    with pytest.raises(TypeError):
        conv3d.conv3d_weight_grad(x.double(), gy)
    with pytest.raises(ValueError, match="must be"):
        conv3d.conv3d_weight_grad(torch.cat([x, x]), torch.cat([gy, gy]))


def test_probe_on_the_cpu(capsys):
    """The probe at a small crop on the CPU: a row for each of the 23
    convs, the kernel's lines (here its plain version) for the 3×3×3 ones
    whose W it takes, within float32 rounding of float64."""
    out = probe.main(["--device", "cpu", "--iters", "1", "--crops",
                      "32x16x16", "--base-filters", "4"])
    assert out["card"] == "cpu" and out["device"] == "cpu"
    crop = out["crops"]["32x16x16"]
    assert [r["name"] for r in crop["rows"]] == NAMES
    assert crop["routed"] == 4
    timed = [r for r in crop["rows"] if "kernel_ms" in r]
    assert len(timed) == 12
    for r in timed:
        assert r["rel_err"] < 1e-5 and r["bit_equal_rerun"]
        assert r["launched"] == 0 and r["kernel_ms"] > 0
    assert all(r["cudnn_ms"] > 0 and r["bound_ms"] > 0 for r in crop["rows"])
    assert "4 routed convs" in capsys.readouterr().out


def test_probe_raises_without_a_gpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.main(["--crops", "32x16x16"])
