"""Readings that ``features-rig``'s ``feat_gap`` limit is set from.

    python3 -m benchmark.calibrate_features --seeds <n> [<n> ...]
        [--workload features-rig] [--window <s>] [--out <file.json>]

For each seed, in one process: the cell's set-up and the window for
``--window`` seconds, then the kept frames' ``feat_gap`` of the program
against the reference (the lower reading) and of the reference computed
with TF32 on, the precision below the float32 that the configuration
states, put in the program's place against the reference in float32 (the
control), through ``benchmark/calibrate.py``'s switch. Not part of a
benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from benchmark import harness, program
from benchmark.calibrate import tf32


def gap(prog, ref) -> float:
    """The largest |prog - ref| of a frame over that frame's largest
    |ref|."""
    return max(float(np.abs(p - r).max() / np.abs(r).max()) for p, r in zip(prog, ref))


def readings(cell, seed: int, window: float, device) -> dict:
    session = cell.traffic.Session(cell, seed, device)
    session.window(window)
    session.release()
    tf32(False)
    ref = [r.cpu().numpy() for r in session.reference()]
    tf32(True)
    ctl = [r.cpu().numpy() for r in session.reference()]
    tf32(False)
    out = dict(seed=seed, kept=len(session.kept), counts=session.counts,
               program=gap([f for _, _, f in session.kept], ref),
               control=gap(ctl, ref))
    del session
    program.free_cuda()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="features-rig")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--window", type=float, default=5.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, harness.load_bench())
    print(f"card: {harness.card_line()}", flush=True)
    rows = []
    for seed in args.seeds:
        t0 = time.time()
        row = readings(cell, seed, args.window, "cuda:0")
        row["seconds"] = time.time() - t0
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(workload=args.workload, card=harness.card_line(),
                           rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
