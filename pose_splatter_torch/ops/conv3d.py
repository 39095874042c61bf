"""The weight and bias gradients of the U-Nets' 3×3×3 convolutions on the
card, and the autograd route that takes them there.

:func:`conv3d_weight_grad` computes, for ``x [1, Cin, D, H, W]`` and the
output gradient ``gy [1, Cout, D, H, W]`` of a 3×3×3 convolution of stride
1 and zero padding 1,

    gw[co, ci, a, b, c] = Σ_{d,h,w} gy[co, d, h, w] · x[ci, d+a−1, h+b−1, w+c−1]
    gb[co]              = Σ_{d,h,w} gy[co, d, h, w]

On a CUDA tensor it launches ``csrc/conv3d_wgrad.cu`` (built at first use)
on the current stream, into an output and a scratch of partial sums
allocated here with ``torch.empty`` (so a CUDA-graph capture takes them
into its pool), and counts the launch in ``conv3d_weight_grad.launches``;
nothing is read back. On a CPU tensor it runs
:func:`conv3d_weight_grad_ref`, the plain version: the same sums as 27
matrix products, one a tap. The two add in different orders, so they
agree to float32 rounding, not bit for bit; the kernel adds in a fixed
order and gives the same bits on every call.

:class:`Conv3dWeightGrad` is the ``torch.autograd.Function`` that
``models/unet3d.py::ConvBlock`` runs where :func:`takes` holds: the forward
is the module's own ``F.conv3d`` call, the backward takes the input
gradient from cuDNN (``aten.convolution_backward``, weight and bias left
out) and the weight and bias gradients from the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from pose_splatter_torch.utils import stages

CO_GROUP = 4        # output channels a warp holds (the kernel's kCo)
WIDTHS = (4, 8, 16, 32, 64, 128)  # W the kernel takes: 4 floats a lane
# Blocks resident at once on an H100 (132 SMs, 3 blocks of 128 threads
# each at the kernel's register bound): the split of the positions fills
# them in one wave. A property of the card the kernel is built for, not of
# the card it runs on, so the split, and with it every bit of the result,
# depends on the shape alone.
RESIDENT_BLOCKS = 132 * 3

# The rule, read off ``scripts/dbg_conv_wgrad_micro.py``'s table (PERF.md
# §6; H100, 700 W): the kernel takes a convolution's weight gradient where
# it has at least MIN_VOXELS positions and at most MAX_CHANNELS input times
# output channels. At 24×20×16 = 7,680 positions it beats cuDNN's
# autotuned gradient 4–6× at 16→32 and 32→32, 2.8× at 64→32 and 32→64,
# 1.6× at 64→64, and loses at 128→64 (0.86×); at 960 positions it wins
# barely at 32→64 (1.10×) and loses above (0.81× at 64→64).
MIN_VOXELS = 7_680
MAX_CHANNELS = 64 * 64


def fits(x_shape: Sequence[int], weight_shape: Sequence[int],
         stride=(1, 1, 1), padding=(1, 1, 1), dilation=(1, 1, 1),
         groups: int = 1) -> bool:
    """Whether the kernel can take the weight gradient of a convolution of
    ``weight_shape`` over an input of ``x_shape``: 3×3×3, stride 1,
    padding 1, dilation 1, one group, batch 1, a multiple of 4 output
    channels and W one of ``WIDTHS``."""
    if len(x_shape) != 5 or len(weight_shape) != 5:
        return False
    n, cin, _, _, W = (int(s) for s in x_shape)
    return (tuple(weight_shape[1:]) == (cin, 3, 3, 3)
            and tuple(stride) == (1, 1, 1) and tuple(padding) == (1, 1, 1)
            and tuple(dilation) == (1, 1, 1) and groups == 1 and n == 1
            and int(weight_shape[0]) % CO_GROUP == 0 and W in WIDTHS)


@functools.lru_cache(maxsize=None)
def takes(x_shape: Sequence[int], weight_shape: Sequence[int],
          stride=(1, 1, 1), padding=(1, 1, 1), dilation=(1, 1, 1),
          groups: int = 1) -> bool:
    """The route's rule, on the shapes alone (given as tuples): the kernel
    :func:`fits` the convolution, which has at least ``MIN_VOXELS``
    positions and at most ``MAX_CHANNELS`` input times output channels.
    Cached: a train step asks it for each of its convs, on the host's
    critical path."""
    return (fits(x_shape, weight_shape, stride, padding, dilation, groups)
            and math.prod(int(s) for s in x_shape[2:]) >= MIN_VOXELS
            and int(x_shape[1]) * int(weight_shape[0]) <= MAX_CHANNELS)


@functools.lru_cache(maxsize=None)
def split(cin: int, cout: int, D: int, H: int, W: int) -> Tuple[int, int]:
    """(steps a chunk, chunks): the kernel's split of its D·⌈H / (128 / W)⌉
    steps of 128 positions into chunks, so that chunks × pair groups (4
    (4-channel group, input channel) pairs a block) fill
    ``RESIDENT_BLOCKS``."""
    steps = D * -(-H // (128 // W))
    pair_blocks = -(-(cout // CO_GROUP) * cin // 4)
    target = max(1, RESIDENT_BLOCKS // pair_blocks)
    per = -(-steps // target)
    return per, -(-steps // per)


def conv3d_weight_grad_ref(x: torch.Tensor, gy: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: for each tap (a, b, c), gy [Cout, P] times
    the zero-padded x shifted by the tap, [Cin, P], transposed; the bias
    gradient gy's sum over its positions."""
    _, cin, D, H, W = x.shape
    cout = gy.shape[1]
    xp = F.pad(x[0], (1, 1, 1, 1, 1, 1))
    g = gy[0].reshape(cout, -1)
    gw = x.new_empty((cout, cin, 3, 3, 3))
    for a in range(3):
        for b in range(3):
            for c in range(3):
                gw[:, :, a, b, c] = g @ xp[:, a:a + D, b:b + H,
                                          c:c + W].reshape(cin, -1).T
    return gw, g.sum(1)


def _check(x: torch.Tensor, gy: torch.Tensor):
    if x.dim() != 5 or gy.dim() != 5 or x.shape[0] != 1 or gy.shape[0] != 1:
        raise ValueError(f"x {tuple(x.shape)} and gy {tuple(gy.shape)} must "
                         "be [1, C, D, H, W]")
    if x.shape[2:] != gy.shape[2:]:
        raise ValueError(f"x {tuple(x.shape)} and gy {tuple(gy.shape)} "
                         "differ in D, H, W")
    if x.dtype != gy.dtype or x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"expected float tensors of one dtype, got "
                        f"{x.dtype} and {gy.dtype}")
    if gy.device != x.device:
        raise ValueError(f"gy is on {gy.device}, x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _check_kernel(x: torch.Tensor, gy: torch.Tensor):
    """What the kernel takes beyond :func:`_check`."""
    cout, W = gy.shape[1], x.shape[4]
    if x.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32, got {x.dtype}")
    if cout % CO_GROUP:
        raise ValueError(f"{cout} output channels: the kernel takes a "
                         f"multiple of {CO_GROUP}")
    if W not in WIDTHS:
        raise ValueError(f"W = {W}: the kernel takes W in {WIDTHS}")
    if x.numel() >= 2 ** 31 or gy.numel() >= 2 ** 31:
        raise ValueError("the kernel takes fewer than 2^31 elements a tensor")
    for name, t in (("x", x), ("gy", gy)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _entry():
    """``csrc/conv3d_wgrad.cu``'s C entry, built (if needed), loaded and
    bound at first launch."""
    from pose_splatter_torch.ops import _build

    fn = _build.load("conv3d_wgrad").conv3d_wgrad
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p] * 4 + [ctypes.c_int] * 7 + [p]
        fn.restype = ctypes.c_int
    return fn


def conv3d_weight_grad(x: torch.Tensor, gy: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gw [Cout, Cin, 3, 3, 3], gb [Cout]) of a 3×3×3 convolution of
    stride 1 and padding 1 over ``x [1, Cin, D, H, W]`` whose output
    gradient is ``gy [1, Cout, D, H, W]``. CPU tensors run
    :func:`conv3d_weight_grad_ref`; CUDA tensors (float32, contiguous,
    16-byte aligned, Cout a multiple of 4, W in ``WIDTHS``) launch
    ``csrc/conv3d_wgrad.cu`` and count it in
    ``conv3d_weight_grad.launches``."""
    _check(x, gy)
    if x.device.type == "cpu":
        return conv3d_weight_grad_ref(x, gy)
    _check_kernel(x, gy)
    _, cin, D, H, W = x.shape
    cout = gy.shape[1]
    per, chunks = split(cin, cout, D, H, W)
    n_w = cout * cin * 27
    out = torch.empty(n_w + cout, dtype=x.dtype, device=x.device)
    part = torch.empty((n_w + cout) * chunks, dtype=x.dtype, device=x.device)
    fn = _entry()
    index = x.device.index
    args = (x.data_ptr(), gy.data_ptr(), part.data_ptr(), out.data_ptr(),
            cin, cout, D, H, W, per, chunks,
            torch._C._cuda_getCurrentRawStream(index))
    if index == torch.cuda.current_device():  # no device switch to pay for
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"conv3d_wgrad launch failed: CUDA error {err}")
    conv3d_weight_grad.launches += 1
    return out[:n_w].view(cout, cin, 3, 3, 3), out[n_w:]


conv3d_weight_grad.launches = 0
stages.count_launches("conv3d_wgrad", conv3d_weight_grad)


class Conv3dWeightGrad(torch.autograd.Function):
    """``F.conv3d(x, weight, bias, padding=1)`` whose backward takes the
    input gradient from cuDNN and the weight and bias gradients from
    :func:`conv3d_weight_grad`."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return F.conv3d(x, weight, bias, (1, 1, 1), (1, 1, 1), (1, 1, 1), 1)

    @staticmethod
    def backward(ctx, gy):
        x, weight = ctx.saved_tensors
        gx = None
        if ctx.needs_input_grad[0]:
            gx = torch.ops.aten.convolution_backward(
                gy, x, weight, None, [1, 1, 1], [1, 1, 1], [1, 1, 1], False,
                [0, 0, 0], 1, [True, False, False])[0]
        gw, gb = conv3d_weight_grad(x.contiguous(), gy.contiguous())
        return gx, gw, gb


def conv3d(conv: torch.nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)``, through :class:`Conv3dWeightGrad` where a graph is
    being built for its weight, on a CUDA float32 input whose shape the
    kernel :func:`takes`; elsewhere (the CPU, no grad, other shapes) the
    module itself."""
    if (torch.is_grad_enabled() and x.is_cuda and x.dtype == torch.float32
            and conv.weight.requires_grad and conv.bias is not None
            and conv.padding_mode == "zeros"
            and takes(x.shape, conv.weight.shape, conv.stride, conv.padding,
                      conv.dilation, conv.groups)):
        return Conv3dWeightGrad.apply(x, conv.weight, conv.bias)
    return conv(x)
