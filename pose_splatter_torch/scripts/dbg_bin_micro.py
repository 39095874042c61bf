"""Micro-benchmarks of the binning and gather constituents on the card
(counterpart of ``scripts/dbg_bin_micro.py``).

    python -m pose_splatter_torch.scripts.dbg_bin_micro [--device cuda|cpu]
        [--seed N] [--iters N] [--n N] [--expand E] [--tiles T]
        [--mcap M]

N = 16000 Gaussians, E = 16 slots each (K = N·E), T = 160 tiles, MCAP =
74240 rows, the script's draws in its order. Its ten items, in its order,
each line ms a call (``probe_common``) under the script's label, which
names its default sizes:

1. sort_key_val 256k: a stable sort of the slots' rows carrying sources;
2. searchsorted 74k in 256k;
3. scatter-set 256k scalars: the slot inversion
   (``rasterize_kernels._invert_slots``: unique indices, a dump column a
   dropped slot, where JAX drops out-of-range indices);
4. scatter-set 256k rows x128: the rows scattered to their slots the same
   way (fused inversion and gather);
5. gather 74k rows x128;
6. slot rank by stable sort [K]: each slot's rank among its tile's earlier
   slots (``rasterize_kernels._slot_rank``, what ``_build_instances``
   does), where the JAX script times ``_excl_cumsum_mxu`` on an [N, T]
   one-hot: the MXU mechanism the port replaced
   (``rasterize_kernels.py:87-110``). The tiles are item 7's draw;
7. take_along_axis [N,16] from [N,160] (from the one-hot's exclusive
   cumsum);
8. elementwise [N,T] rect test;
9. argsort 16k f32 (the depth sort, stable);
10. sort_key_val 64k (expand 4).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from pose_splatter_torch.ops import rasterize_kernels as K
from pose_splatter_torch.scripts import probe_common as pc

N, E, T, MCAP = 16000, 16, 160, 74240


def inputs(dev, N: int = N, E: int = E, T: int = T, mcap: int = MCAP,
           seed: int = 0) -> Dict[str, torch.Tensor]:
    """The script's arrays, drawn in its order, on ``dev``."""
    rng = np.random.default_rng(seed)
    k = N * E
    a = dict(dest=np.where(rng.uniform(size=k) < 0.2,
                           rng.integers(0, mcap, k), mcap + np.arange(k)),
             src=rng.integers(0, N, k),
             packed=rng.normal(size=(N, 128)).astype(np.float32),
             oh=(rng.uniform(size=(N, T)) < 0.02).astype(np.float32),
             tile=rng.integers(0, T, (N, E)),
             cx=rng.uniform(0, 576, N).astype(np.float32),
             depth=rng.normal(size=N).astype(np.float32))
    return {name: torch.from_numpy(np.asarray(x)).to(dev)
            for name, x in a.items()}


def sort_key_val(keys, vals):
    s, order = torch.sort(keys, stable=True)
    return s, vals[order]


def scatter_rows(dest, packed, src, mcap: int):
    """Item 4: ``zeros((mcap, 128)).at[dest].set(packed[src], mode="drop")``
    as the port scatters: unique indices, a dump row a dropped slot."""
    k = dest.shape[0]
    idx = torch.where(dest < mcap, dest,
                      mcap + torch.arange(k, device=dest.device))
    out = packed.new_zeros((mcap + k, packed.shape[1]))
    out[idx] = packed[src]
    return out[:mcap]


def excl_cumsum(oh):
    """Exclusive cumsum of [N, T] along axis 0 (what ``_excl_cumsum_mxu``
    returns first)."""
    return torch.cumsum(oh, 0) - oh


def rect(cx, T: int = T):
    """Item 8 (``dbg_bin_micro.py:82-85``)."""
    tty = (torch.arange(T, device=cx.device) // 4)[None, :]
    ry = tty - torch.div(cx[:, None], 37, rounding_mode="floor").long()
    return ((ry >= 0) & (ry < 3)).float()


def run(device="cuda", seed: int = 0, iters: int = 20, N: int = N,
        E: int = E, T: int = T, mcap: int = MCAP) -> Dict:
    probe = pc.Probe(device, iters, width=34)
    x = inputs(probe.dev, N, E, T, mcap, seed)
    dest, src, packed = x["dest"], x["src"], x["packed"]
    probe.time("sort_key_val 256k",
               lambda: sort_key_val(dest, src))
    ds, _ = sort_key_val(dest, src)
    want = torch.arange(mcap, device=probe.dev)
    probe.time("searchsorted 74k in 256k",
               lambda: torch.searchsorted(ds, want))
    probe.time("scatter-set 256k scalars",
               lambda: K._invert_slots(dest[None], src[None], N, mcap))
    probe.time("scatter-set 256k rows x128",
               lambda: scatter_rows(dest, packed, src, mcap))
    invc = torch.clamp(K._invert_slots(dest[None], src[None], N, mcap)[0],
                       max=N - 1)
    probe.time("gather 74k rows x128",
               lambda: packed.index_select(0, invc))
    flat = x["tile"].reshape(-1)
    counts = torch.bincount(flat, minlength=T)
    probe.time("slot rank by stable sort [256k]",
               lambda: K._slot_rank(flat, counts))
    excl = excl_cumsum(x["oh"])
    probe.time("take_along_axis [N,16]",
               lambda: torch.take_along_dim(excl, x["tile"], 1))
    probe.time("elementwise [N,T] rect test", lambda: rect(x["cx"], T))
    probe.time("argsort 16k f32",
               lambda: torch.sort(x["depth"], stable=True).indices)
    probe.time("sort_key_val 64k",
               lambda: sort_key_val(dest[:N * 4], src[:N * 4]))
    return probe.result()


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = pc.parser(__doc__, iters=20)
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--expand", type=int, default=E)
    ap.add_argument("--tiles", type=int, default=T)
    ap.add_argument("--mcap", type=int, default=MCAP)
    a = ap.parse_args(argv)
    return run(a.device, a.seed, a.iters, a.n, a.expand, a.tiles, a.mcap)


if __name__ == "__main__":
    main()
