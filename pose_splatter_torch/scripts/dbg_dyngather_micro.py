"""Microbench of the dynamic-gather kernel on an NVIDIA GPU (counterpart of
``scripts/dbg_dyngather_micro.py``'s ``__main__``).

    python -m pose_splatter_torch.scripts.dbg_dyngather_micro [--seed N]

Checks one gather along each axis of an ``arange`` table against numpy
(``OK`` / ``MISMATCH``), then times the repeated gather (reps 32) at the
image-table shape [2304, 128] (576x512 flattened) for three index
patterns: random rows (axis 0), row broadcast (every lane of output row i
reads source row s_i, axis 0) and random lanes (axis 1). Times come from
CUDA events over many launches of the kernel after a warm-up; each line
names the card. They are host-launched rates: at this size a launch's
device work takes less time than the host's Python takes to issue it, so
the lines time the launch path and move with the host from run to run.
The device's own time a launch (launches captured in one CUDA graph and
replayed between CUDA events) is shorter, and the launch floor (a
one-element ``zero_()`` replayed so) bounds it from below; compare a
host-launched time only with another. Runs on the GPU and raises where
there is none. Indices come from ``np.random.default_rng(seed)``.

The rates are per gather the kernel does, not per term of the sum. Whatever
``reps`` is, an element reads only two distinct table entries (offsets 0
and 1); the kernel loads each once and adds them ``reps`` times in
registers. So ``ns/elem`` divides the time by ``S * L * min(reps, 2)``
gathers and ``ns/row`` by ``S * min(reps, 2)``. The TPU script divides by
``S * L * reps``, the gathers its Mosaic loop issues; the two rates measure
different work and are not to be set side by side.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from pose_splatter_torch.ops import dyngather as D
from pose_splatter_torch.utils.device import cuda_ms, resolve_device

S = 2304  # image rows of 128 (576*512/128)
L = 128
REPS = 32
ITERS, WARMUP = 200, 10  # timed launches a probe line, after the warm-up


def probe_correct(device="cuda", seed: int = 0) -> Dict[int, bool]:
    """One gather along each axis of ``arange(S*L)`` by random indices,
    against ``np.take_along_axis``; prints and returns OK per axis."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    tab_np = np.arange(S * L, dtype=np.float32).reshape(S, L)
    tab = torch.from_numpy(tab_np).to(dev)
    ok = {}
    for axis in (0, 1):
        hi = S if axis == 0 else L
        idx_np = rng.integers(0, hi, (S, L)).astype(np.int32)
        out = D.gather(tab, torch.from_numpy(idx_np).to(dev), axis)
        expect = np.take_along_axis(tab_np, idx_np, axis=axis)
        ok[axis] = bool(np.array_equal(out.cpu().numpy(), expect))
        print(f"axis={axis} correctness: {'OK' if ok[axis] else 'MISMATCH'}")
    return ok


def probe(axis: int, name: str, idx_np: np.ndarray, rng, card: str,
          reps: int = REPS) -> Dict:
    """Time the kernel on a random table and ``idx_np`` and print the line.
    One wrapper call checks the inputs; the timed loop then launches the
    kernel through ``dyngather.launch``, which counts every launch."""
    dev = torch.device("cuda")
    tab = torch.from_numpy(rng.random((S, L), dtype=np.float32)).to(dev)
    idx = torch.from_numpy(idx_np.astype(np.int32)).to(dev)
    out = D.gather_sum(tab, idx, axis, reps)
    ms = cuda_ms(lambda: D.launch(D.gather_sum, tab, idx, out, axis, reps),
                 ITERS, WARMUP)
    loads = min(reps, 2)  # distinct table entries an element reads
    n = S * L * loads
    print(f"{name}: {ms:7.4f} ms for {reps} reps ({ms * 1e6 / n:.4f} ns/elem, "
          f"{ms * 1e6 / (S * loads):.2f} ns/row, per gather done) on {card}",
          flush=True)
    return dict(name=name.strip(), axis=axis, reps=reps, ms=ms,
                ns_per_elem=ms * 1e6 / n, ns_per_row=ms * 1e6 / (S * loads))


def probe_lines(rng, card: str):
    """The three probe lines of the TPU script, in its order."""
    s = rng.integers(0, S - 1, (S, 1))
    return [
        # Random per-element row gather (worst case).
        probe(0, "dim0 random  ", rng.integers(0, S - 1, (S, L)), rng, card),
        # Row broadcast: the full-row fetch pattern of a carve sampler.
        probe(0, "dim0 rowbcast", s.repeat(L, 1), rng, card),
        # Lane gather within a row.
        probe(1, "dim1 random  ", rng.integers(0, L - 1, (S, L)), rng, card),
    ]


def run(seed: int = 0) -> Dict:
    """The probe on the GPU: the correctness check, then the three lines."""
    resolve_device("cuda")
    card = torch.cuda.get_device_name(0)
    print(f"device: {card}")
    ok = probe_correct("cuda", seed=seed)
    return dict(card=card, correct=ok,
                probes=probe_lines(np.random.default_rng(seed + 1), card))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    return 0 if all(run(args.seed)["correct"].values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
