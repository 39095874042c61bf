"""The card's launch floor: ms an iteration of trivial work chained like
a bench loop (counterpart of ``scripts/dbg_dispatch_floor.py``).

    python -m pose_splatter_torch.scripts.dbg_dispatch_floor
        [--device cuda|cpu] [--iters N] [--size S] [--big S]

The script's three lines, each call consuming the last one's output: a
256x256 float32 matmul (``tiny matmul``), ten of them, each scaled by
1e-3 (``tiny chain x10``: 20 eager launches here, one jitted dispatch on
the TPU), and a 2048x2048 matmul scaled by 1e-4 (``2048 matmul``). Each
line is ms an iteration by CUDA events over ``--iters`` iterations (50,
as the script) after one (``probe_common``). The JAX script's "SoL"
figure (0.09 ms) is the TPU's. The port prints the card's own bound
beside the last line instead: 2·2048³ = 17.2 GFLOP at the H100's float32
peak outside the tensor cores (67 TFLOP/s, SXM data sheet, at 700 W;
TF32 is off in every entry point), 0.256 ms, with the card's name and
power limit as ``nvidia-smi`` reports them.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from pose_splatter_torch.scripts import probe_common as pc

PEAK_FP32 = 67e12  # H100 SXM float32 outside the tensor cores, FLOP/s
SMALL, BIG = 256, 2048


def chained(fn, x):
    """A no-argument call of ``fn`` on the previous call's output."""
    state = [x]

    def step():
        state[0] = fn(state[0])
        return state[0]

    return step


def run(device="cuda", iters: int = 50, small: int = SMALL,
        big: int = BIG) -> Dict:
    probe = pc.Probe(device, iters, width=14, fmt=".3f")
    x = torch.ones((small, small), device=probe.dev)

    def tiny_chain(x):
        for _ in range(10):
            x = x @ x * 1e-3
        return x

    probe.time("tiny matmul", chained(lambda x: x @ x, x))
    probe.time("tiny chain x10", chained(tiny_chain, x))
    big_x = torch.ones((big, big), device=probe.dev)
    ms = probe.time(f"{big} matmul", chained(lambda a: a @ a * 1e-4, big_x))
    bound = 1e3 * 2 * big ** 3 / PEAK_FP32
    if probe.dev.type == "cuda":
        print(f"  bound: {2 * big ** 3 / 1e9:.1f} GFLOP at 67 TFLOP/s float32 "
              f"= {bound:.3f} ms ({100 * bound / ms:.1f} % of the line) on "
              f"{probe.card}", flush=True)
    return probe.result(bound_ms=bound, bound_share=bound / ms)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = pc.parser(__doc__, iters=50)
    ap.add_argument("--size", type=int, default=SMALL)
    ap.add_argument("--big", type=int, default=BIG)
    a = ap.parse_args(argv)
    return run(a.device, a.iters, a.size, a.big)


if __name__ == "__main__":
    main()
