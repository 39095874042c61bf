"""Readings that the limits of an adaptive-camera training cell's
``correct`` are set from (``traffic/train_adaptive.py``): those of
``benchmark.calibrate`` and ``first_loss_gap``, which that tool does not
compute, with the leaves behind each ``grad_gap`` and ``step_gap``.

    python3 -m benchmark.calibrate_adaptive --workload <cell> --seeds <n> [<n> ...]
        [--float64] [--out <file.json>]

For each seed, in one process: the cell's set-up and checked steps, then
the program against the reference in float32 (``program``), the reference
with lr 0 (``unchanged``) and the reference with TF32 on (``control``),
each against the reference in float32. With ``--float64`` the reference is
run once more in float64 (``float64_reference``), and the program, the
float32 reference and the control are each read against it: where the
program's gap to float64 is of the float32 reference's, the program's gap
to the float32 reference is round-off that any float32 step carries. Not
part of a benchmark run.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import sys
import time

import numpy as np
import torch

from benchmark import calibrate, compare, harness, program
from benchmark.reference import adaptive as reference
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train


def leaf_gaps(prog: dict, ref: dict, n: int = 3) -> dict:
    """The ``n`` leaves with the widest gaps behind ``compare.train_gaps``'
    ``grad_gap`` and ``step_gap``, each on that number's own scale."""
    g_ref, c_ref = ref["grad_norms"], ref["change_norms"]
    reached = {k: v for k, v in g_ref.items() if v is not None}
    med_g = statistics.median(reached.values())
    moved = [k for k, v in reached.items() if v >= compare.MOVED_SHARE * med_g]
    med_c = statistics.median(c_ref[k] for k in moved)
    grad = [(abs((prog["grad_norms"].get(k) or 0.0) - r) / max(r, med_g), k)
            for k, r in reached.items()]
    step = [(abs((prog["change_norms"].get(k) or 0.0) - c_ref[k]) / max(c_ref[k], med_c), k)
            for k in moved]
    return {name: [[float(f"{g:.3g}"), k] for g, k in sorted(rows, reverse=True)[:n]]
            for name, rows in (("grad", grad), ("step", step))}


class _Torch64:
    """``torch`` as the reference's modules see it in a float64 run: the
    name ``float32`` means float64, everything else is torch's own."""

    float32 = torch.float64

    def __getattr__(self, name):
        return getattr(torch, name)


def _select64(vol0, spec):
    """``reference.model.select`` on a float64 volume: the order, the
    threshold and the kept set from the float32 values (as the program
    computes them), the kept values and probabilities in float64."""
    v32 = vol0.detach().float().contiguous()
    bits = v32.view(torch.int32)
    order = torch.sort(bits ^ ((bits >> 31) & 0x7FFFFFFF), descending=True,
                       stable=True).indices
    host = v32.index_select(0, order).cpu().numpy()
    n_top = int((bits > 0x7F800000).sum())
    f32 = np.float32
    lo_pos, hi_pos = n_top + spec.min_n - 1, n_top + spec.max_n
    v_lo = host[lo_pos]
    v_hi = host[hi_pos] if hi_pos < len(host) and not np.isnan(host[hi_pos]) else -np.inf
    lp = f32(math.log(spec.pt / (1.0 - spec.pt)))
    mt, delta = f32(spec.mt), f32(spec.delta)
    while v_hi > f32(mt + lp):
        mt = f32(mt + delta)
    while not v_lo > f32(mt + lp):
        mt = f32(mt - delta)
    thr = float(f32(mt + lp))
    idx = order[:spec.max_n]
    vals = vol0.index_select(0, idx)
    return idx, v32.index_select(0, idx) > thr, torch.sigmoid(vals - float(mt))


def _carve32(carve):
    """The adaptive carve in float32, as the program carves (which voxels
    a view sees is a decision, not a value a gradient reaches), returning
    the volume in float64."""
    def run(*args):
        prev = torch.get_default_dtype()
        torch.set_default_dtype(torch.float32)
        try:
            args = [a.float() if torch.is_tensor(a) and a.is_floating_point() else a
                    for a in args]
            return carve(*args).double()
        finally:
            torch.set_default_dtype(prev)
    return run


@contextlib.contextmanager
def float64_reference():
    """``reference.train_steps`` runs in float64 inside: every tensor the
    reference's modules make as float32 is float64, the selection and the
    carve decide in float32 as the program does."""
    saved = [(ref_model, "torch", ref_model.torch), (ref_train, "torch", ref_train.torch),
             (ref_model, "select", ref_model.select),
             (reference, "carve", reference.carve)]
    prev = torch.get_default_dtype()
    ref_model.torch = ref_train.torch = _Torch64()
    ref_model.select = _select64
    reference.carve = _carve32(reference.carve)
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(prev)
        for mod, name, value in saved:
            setattr(mod, name, value)


def _double(x):
    return x.double() if torch.is_tensor(x) and x.is_floating_point() else x


def reference64(session) -> dict:
    """The session's reference steps in float64."""
    weights = {k: _double(v) for k, v in session.inputs.weights().items()}
    cams = ref_model.Cameras(_double(session.cameras.Ks), _double(session.cameras.Es),
                             session.spec)
    steps = [{k: _double(v) for k, v in s.items()} for s in session.ref_steps]
    with float64_reference():
        return reference.train_steps(
            weights, session.spec, cams, _double(session.grid), steps, session.spec.lr,
            session.cell.config["gaussian_config"].get("instance_cap"))


def readings(cell, seed: int, device, f64: bool = False) -> dict:
    session = cell.traffic.Session(cell, seed, device)
    session.release()
    calibrate.tf32(False)
    ref = session.reference()
    unchanged = session.reference(lr=0.0)
    calibrate.tf32(True)
    control = session.reference()
    calibrate.tf32(False)
    out = dict(seed=seed, program=session.gaps(session.prog, ref),
               unchanged=session.gaps(unchanged, ref),
               control=session.gaps(control, ref),
               leaves=dict(program=leaf_gaps(session.prog, ref),
                           control=leaf_gaps(control, ref)))
    if f64:
        t0 = time.time()
        ref64 = reference64(session)
        out["float64"] = {
            name: dict(gaps=session.gaps(side, ref64), leaves=leaf_gaps(side, ref64))
            for name, side in (("program", session.prog), ("reference", ref),
                               ("control", control))}
        out["float64"]["seconds"] = time.time() - t0
    del session
    program.free_cuda()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--float64", action="store_true")
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
        row = readings(cell, seed, "cuda:0", args.float64)
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
