"""Micro-benchmark of the final U-Net's convolution weight gradients:
cuDNN's against the hand-written kernel (``ops/conv3d.py``), conv by conv.

    python -m pose_splatter_torch.scripts.dbg_conv_wgrad_micro
        [--device cuda|cpu] [--seed N] [--iters N]
        [--crops 96x80x64,192x160x128] [--base-filters 8]

For each crop, the 23 convolutions of ``Unet3D(4, 8, base_filters)`` (18
3×3×3 convs of the ConvBlocks, 4 transpose convs, the final 1×1×1) with
their shapes read off a forward on the meta device, random inputs and
output gradients from ``--seed``, and one row each:

- ``cudnn_ms``: the weight and bias gradients by
  ``aten.convolution_backward`` (input gradient left out), which autograd
  runs for ``nn.Conv3d``, with cuDNN's autotuning on;
- ``kernel_ms``: :func:`conv3d_weight_grad`, where the kernel can take the
  conv (3×3×3 with a multiple of 4 output channels and W in
  ``conv3d.WIDTHS``), whether or not the route's rule
  (:func:`conv3d.takes`) sends it there (``routed``);
- ``plain_ms``: :func:`conv3d_weight_grad_ref` (27 matrix products);
- ``bound_ms``: max(FLOPs / 67 TFLOP/s, bytes / 3.35 TB/s), H100 SXM
  float32 without the tensor cores and HBM3: 2 · weight entries ·
  positions, and x, gy, gw and gb each read or written once;
- ``rel_err``: the kernel's largest gap to the plain version in float64,
  over the float64 gradient's largest entry (weights and bias apart).

On the card each time is one call's device ms by CUDA-graph replay
(``scripts/bench.py::graph_device_ms``, warm-up calls first, so cuDNN has
timed its candidates); on the CPU (``--device cpu``, small crops only)
the host clock, a time of the CPU.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn as nn

from pose_splatter_torch.models.unet3d import Unet3D
from pose_splatter_torch.ops import conv3d
from pose_splatter_torch.utils.device import call_ms, card_line, resolve_device

CROPS = ((96, 80, 64), (192, 160, 128))  # the 2D presets' and high-res crop
PEAK_FLOPS = 67e12   # H100 SXM float32 (FFMA), FLOP/s
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s


def unet_convs(crop: Sequence[int], base_filters: int = 8) -> List[Dict]:
    """The convolutions of the final ``Unet3D(4, 8, base_filters)`` at
    ``crop`` in module order, from a forward on the meta device: name,
    module, input and output shapes, and whether the route's rule sends its
    weight gradient to the kernel (``routed``)."""
    with torch.device("meta"):
        net = Unet3D(4, 8, base_filters, input_size=tuple(crop))
    rows, hooks = [], []
    for name, mod in net.named_modules():
        if isinstance(mod, (nn.Conv3d, nn.ConvTranspose3d)):
            def hook(m, inp, out, name=name):
                x = tuple(inp[0].shape)
                rows.append(dict(
                    name=name, module=m, x=x, y=tuple(out.shape),
                    routed=isinstance(m, nn.Conv3d) and conv3d.takes(
                        x, m.weight.shape, m.stride, m.padding, m.dilation,
                        m.groups)))
            hooks.append(mod.register_forward_hook(hook))
    net(torch.empty((1, 4, *crop), device="meta"), {})
    for h in hooks:
        h.remove()
    return rows


def kernel_can_take(row: Dict) -> bool:
    """The kernel's own limits (:func:`conv3d.fits`), not the rule's
    thresholds."""
    m = row["module"]
    return isinstance(m, nn.Conv3d) and conv3d.fits(
        row["x"], m.weight.shape, m.stride, m.padding, m.dilation, m.groups)


def bound(row: Dict) -> Dict:
    """FLOPs, bytes and the least ms at the card's peaks (see the
    module's docstring)."""
    m = row["module"]
    positions = min(math.prod(row["x"][2:]), math.prod(row["y"][2:]))
    flops = 2 * m.weight.numel() * positions
    nbytes = 4 * (math.prod(row["x"]) + math.prod(row["y"]) + m.weight.numel()
                  + m.weight.shape[1 if isinstance(m, nn.ConvTranspose3d)
                                   else 0])
    return dict(gflop=flops / 1e9, mbytes=nbytes / 1e6,
                bound_ms=1e3 * max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES),
                bound_by="flops" if flops / PEAK_FLOPS >= nbytes / PEAK_BYTES
                else "bytes")


def cudnn_wgrad(row: Dict, x: torch.Tensor, gy: torch.Tensor,
                w: torch.Tensor):
    """The weight and bias gradients as autograd takes them for the module
    of weight ``w``: ``aten.convolution_backward`` with the input gradient
    left out."""
    m = row["module"]
    transposed = isinstance(m, nn.ConvTranspose3d)
    return torch.ops.aten.convolution_backward(
        gy, x, w, [w.shape[1] if transposed else w.shape[0]],
        list(m.stride), list(m.padding), list(m.dilation), transposed,
        list(m.output_padding) if transposed else [0, 0, 0], m.groups,
        [False, True, True])[1:]


def _rel_err(got, want) -> float:
    return max(float((a.double() - b).abs().max() / b.abs().max())
               for a, b in zip(got, want))


def run(device="cuda", seed: int = 0, iters: int = 20,
        crops: Sequence[Sequence[int]] = CROPS,
        base_filters: int = 8) -> Dict:
    dev = resolve_device(device)
    card = card_line(dev)
    if dev.type == "cuda":
        from pose_splatter_torch.scripts.bench import graph_device_ms

        def timer(fn):
            return graph_device_ms(fn, (), iters)
        clock = "device ms a call by CUDA-graph replay"
    else:
        def timer(fn):
            return call_ms(fn, dev, iters)
        clock = "the host clock (a CPU time)"
    print(f"device: {card}; {clock}, {iters} calls a line", flush=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = dict(card=card, device=str(dev), iters=iters, crops={})
    for crop in crops:
        rows = unet_convs(crop, base_filters)
        for row in rows:
            x = torch.randn(row["x"], device=dev, generator=gen)
            gy = torch.randn(row["y"], device=dev, generator=gen)
            w = torch.randn(row["module"].weight.shape, device=dev,
                            generator=gen)
            row.update(bound(row))
            row["cudnn_ms"] = timer(lambda: cudnn_wgrad(row, x, gy, w))
            if kernel_can_take(row):
                before = conv3d.conv3d_weight_grad.launches
                got = conv3d.conv3d_weight_grad(x, gy)
                row["launched"] = conv3d.conv3d_weight_grad.launches - before
                want = conv3d.conv3d_weight_grad_ref(x.double(), gy.double())
                row["rel_err"] = _rel_err(got, want)
                row["bit_equal_rerun"] = all(
                    bool(torch.equal(a, b)) for a, b in
                    zip(got, conv3d.conv3d_weight_grad(x, gy)))
                row["kernel_ms"] = timer(
                    lambda: conv3d.conv3d_weight_grad(x, gy))
                row["plain_ms"] = timer(
                    lambda: conv3d.conv3d_weight_grad_ref(x, gy))
            del x, gy, w
            k = row.get("kernel_ms")
            print(f"{'x'.join(map(str, crop))} {row['name']:15s} "
                  f"{row['x'][1]:3d}->{row['y'][1]:3d} at "
                  f"{'x'.join(map(str, row['y'][2:]))}: {row['gflop']:.3f} "
                  f"GFLOP, bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
                  f"cudnn {row['cudnn_ms']:.4f} ms"
                  + (f", kernel {k:.4f} ms ({row['cudnn_ms'] / k:.2f}x, "
                     f"{100 * row['bound_ms'] / k:.1f} % of bound), plain "
                     f"{row['plain_ms']:.4f} ms, rel err "
                     f"{row['rel_err']:.2e}, rerun bit-equal "
                     f"{row['bit_equal_rerun']}" if k is not None else "")
                  + (" [routed]" if row["routed"] else ""), flush=True)
            del row["module"]
        routed = [r for r in rows if r["routed"]]
        total = dict(
            routed=len(routed),
            cudnn_ms=sum(r["cudnn_ms"] for r in rows),
            routed_cudnn_ms=sum(r["cudnn_ms"] for r in routed),
            routed_kernel_ms=sum(r["kernel_ms"] for r in routed),
            routed_bound_ms=sum(r["bound_ms"] for r in routed))
        total["with_kernel_ms"] = (total["cudnn_ms"] - total["routed_cudnn_ms"]
                                   + total["routed_kernel_ms"])
        print(f"{'x'.join(map(str, crop))}: {total['routed']} routed convs, "
              f"cudnn {total['routed_cudnn_ms']:.4f} ms -> kernel "
              f"{total['routed_kernel_ms']:.4f} ms (bound "
              f"{total['routed_bound_ms']:.4f}); all 23 weight gradients "
              f"{total['cudnn_ms']:.4f} -> {total['with_kernel_ms']:.4f} ms",
              flush=True)
        out["crops"]["x".join(map(str, crop))] = dict(rows=rows, **total)
    return out


def _crop(s: str):
    return tuple(int(v) for v in s.split("x"))


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the inputs and output gradients")
    ap.add_argument("--iters", type=int, default=20,
                    help="timed calls (graph replays) a line")
    ap.add_argument("--crops", default="96x80x64,192x160x128",
                    help="comma-separated DxHxW crops, each side a "
                         "multiple of 16")
    ap.add_argument("--base-filters", type=int, default=8)
    a = ap.parse_args(argv)
    return run(a.device, a.seed, a.iters,
               [_crop(c) for c in a.crops.split(",")], a.base_filters)


if __name__ == "__main__":
    main()
