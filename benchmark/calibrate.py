"""Readings that the limits of ``correct`` are set from.

    python3 -m benchmark.calibrate --workload <cell> --seeds <n> [<n> ...]
        [--window <s>] [--out <file.json>]

For each seed, in one process: the cell's set-up (in a training cell,
its checked steps), the window for ``--window`` seconds where the cell
serves frames, then the program's numbers against the reference (the
lower readings) and the control's: the reference computed with TF32 on,
the precision just below the float32 that the configuration states, put
in the program's place against the reference in float32 (the upper
readings). Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import compare, harness, program


def tf32(on: bool):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def detail(prog: dict, ref: dict, n: int = 4) -> dict:
    """Both sides' losses and the leaves with the widest gaps."""
    rows = {}
    for key in ("grad_norms", "change_norms"):
        gaps = [(abs((prog[key].get(k) or 0.0) - (r or 0.0)) / max(r or 0.0, 1e-30), k,
                 prog[key].get(k), r) for k, r in ref[key].items()]
        rows[key] = sorted(gaps, key=lambda g: -g[0])[:n]
    return dict(losses=[prog["losses"], ref["losses"]], **rows)


def readings(cell, seed: int, window: float, device, control: bool = True) -> dict:
    session = cell.traffic.Session(cell, seed, device)
    if session.kind == "render":
        session.window(window)
    session.release()
    tf32(False)
    ref = session.reference()
    out = dict(seed=seed)
    if session.kind == "train":
        out["program"] = compare.train_gaps(session.prog, ref)
        out["detail"] = detail(session.prog, ref)
        # The fault "a step that returns its state unchanged", planted in
        # the reference put in the program's place: lr 0.
        unchanged = session.reference(lr=0.0)
        out["unchanged"] = compare.train_gaps(unchanged, ref)
        if control:
            tf32(True)
            out["control"] = compare.train_gaps(session.reference(), ref)
    else:
        out["program"] = compare.render_gaps(session.kept, ref)
        out["kept"] = len(session.kept)
        if control:
            tf32(True)
            ctl = session.reference()
            out["control"] = compare.render_gaps(
                [(p, compare.u8_host(ctl[p]), ctl[p]) for p in ctl], ref)
    tf32(False)
    del session
    program.free_cuda()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--window", type=float, default=10.0)
    ap.add_argument("--no-control", action="store_true")
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
        row = readings(cell, seed, args.window, "cuda:0", not args.no_control)
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
