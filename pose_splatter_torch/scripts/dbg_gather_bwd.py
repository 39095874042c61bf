"""Probe of the instance gather's backward at the bench shape
(counterpart of ``scripts/dbg_gather_bwd.py``).

    python -m pose_splatter_torch.scripts.dbg_gather_bwd [--device cuda|cpu]
        [--seed N] [--iters N] [--n N] [--expand E] [--mcap M] [--fs F]

N = 16000 Gaussians, E = 16 slots each, mcap = 74240 instance rows, the
script's draws in its order (30 % of the slots live at random rows, the
rest dead). Lines, in the script's order:

- bwd current (16-lane gather): ``dpacked[n] = Σ_e dinst[dest[n, e], :16]``
  with dead slots masked (``dbg_gather_bwd.py:35-40``);
- bwd full-row gather + slice: dead slots read an appended zero row, whole
  rows are gathered, summed, then cut to 16 columns (``:43-49``). At the
  port's packing, F = 16 columns (``--fs``, default 16; the JAX script's
  FS = 128 packing is ``--fs 128``), this is what
  ``rasterize_kernels.gather_instances``' backward does;
- fwd gather_instances: the port's forward (``rasterize_kernels.py``);
- sort_key_val [N*E]: a stable sort of the slots' rows carrying their
  sources;
- invert_slots: the port's slot inversion, one scatter of unique indices
  with a dump column a dropped slot (``rasterize_kernels._invert_slots``),
  where the JAX script times its ``_invert_slots``;
- ``allclose:`` whether the two backward forms agree (``np.allclose``).

Lines are ms a call (``probe_common``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from pose_splatter_torch.ops import rasterize_kernels as K
from pose_splatter_torch.scripts import probe_common as pc

N, E, MCAP, FS = 16000, 16, 74240, K.F


def inputs(dev, N: int = N, E: int = E, mcap: int = MCAP, fs: int = FS,
           seed: int = 0):
    """dest [N*E], dinst [mcap, fs], packed [N, 16], src [N*E] on ``dev``,
    drawn as the script draws them (its first ``dest``, a permutation, is
    drawn and replaced, as there)."""
    rng = np.random.default_rng(seed)
    rng.permutation(mcap + N * E)
    rows = np.where(rng.random(N * E) < 0.3, rng.integers(0, mcap, N * E),
                    mcap + np.arange(N * E))
    dinst = rng.normal(size=(mcap, fs)).astype(np.float32)
    packed = rng.normal(size=(N, 16)).astype(np.float32)
    src = np.repeat(np.arange(N), E)
    return tuple(torch.from_numpy(a).to(dev) for a in (
        rows.astype(np.int64), dinst, packed, src.astype(np.int64)))


def bwd_current(dinst, dest, N: int, mcap: int):
    """``dbg_gather_bwd.py:35-40``."""
    live = dest < mcap
    rows = torch.where(live, dest, torch.zeros_like(dest))
    dslots = torch.where(live[:, None], dinst[rows, :16],
                         torch.zeros((), dtype=dinst.dtype, device=dinst.device))
    return dslots.reshape(N, -1, 16).sum(1)


def bwd_fullrow(dinst, dest, N: int, mcap: int):
    """``dbg_gather_bwd.py:43-49``."""
    rows = torch.where(dest < mcap, dest, torch.full_like(dest, mcap))
    dpad = torch.cat([dinst, dinst.new_zeros((1, dinst.shape[1]))], 0)
    full = dpad.index_select(0, rows)  # whole rows
    return full.reshape(N, -1, dinst.shape[1]).sum(1)[:, :16]


def run(device="cuda", seed: int = 0, iters: int = 10, N: int = N,
        E: int = E, mcap: int = MCAP, fs: int = FS) -> Dict:
    probe = pc.Probe(device, iters, width=29, fmt=".2f")
    dest, dinst, packed, src = inputs(probe.dev, N, E, mcap, fs, seed)
    probe.time("bwd current (16-lane gather)",
               lambda: bwd_current(dinst, dest, N, mcap))
    probe.time("bwd full-row gather + slice",
               lambda: bwd_fullrow(dinst, dest, N, mcap))
    probe.time("fwd gather_instances", lambda: K.gather_instances(
        packed[None], dest[None], src[None], mcap))

    def sort_key_val():
        keys, order = torch.sort(dest, stable=True)
        return keys, src[order]

    probe.time("sort_key_val [N*E]", sort_key_val)
    probe.time("invert_slots", lambda: K._invert_slots(dest[None], src[None],
                                                       N, mcap))
    close = bool(np.allclose(bwd_current(dinst, dest, N, mcap).cpu().numpy(),
                             bwd_fullrow(dinst, dest, N, mcap).cpu().numpy()))
    print("allclose:", close, flush=True)
    return probe.result(allclose=close, fs=fs)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = pc.parser(__doc__, iters=10)
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--expand", type=int, default=E)
    ap.add_argument("--mcap", type=int, default=MCAP)
    ap.add_argument("--fs", type=int, default=FS)
    a = ap.parse_args(argv)
    return run(a.device, a.seed, a.iters, a.n, a.expand, a.mcap, a.fs)


if __name__ == "__main__":
    main()
