"""Finds a cell's files by name, runs it once, and prints its result.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic kind. Each is a file of its own:
``configs/<config>.json`` (the model's sizes), ``workloads/<cell>.json``
(the traffic's parameters, the cell's limits), ``traffic/<traffic>.py``
(the code that drives that kind of traffic) and ``metrics/<metric>.py``
(one reader a per-layer metric). Nothing here names a cell, a
configuration or a metric, so adding one is adding files and entries.

A run: set-up (the traffic's ``Session``: the program built, its weights
and inputs made from the seed, every shape warmed up), then either the
timed window (``--trace 0``: the end-to-end metrics) or the traced run
(``--trace 1``: plain units for the FLOP rate, units with the stage marks
under the profiler, units under the profiler alone), then the program's
state freed and its outputs held against the plain reference.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pose_splatter_tpu")
# Units of the traced run: with the marks (and the profiler), then under
# the profiler alone; the FLOP rate takes this share of ``--seconds``.
MARKED_UNITS = {"train": 3, "render": 6}
PROFILED_UNITS = {"train": 4, "render": 12}
MFU_SHARE = 0.5


class Registry:
    """Looks a name up under each directory in turn (later ones are the
    benchmark's own)."""

    def __init__(self, dirs: Sequence[Path] = (HERE,)):
        self.dirs = [Path(d) for d in dirs]

    def path(self, kind: str, name: str, suffix: str) -> Path:
        for d in self.dirs:
            p = d / kind / f"{name}{suffix}"
            if p.is_file():
                return p
        raise FileNotFoundError(f"no {kind}/{name}{suffix} under "
                                f"{[str(d) for d in self.dirs]}")

    def json(self, kind: str, name: str) -> dict:
        return json.loads(self.path(kind, name, ".json").read_text())

    def module(self, kind: str, name: str):
        path = self.path(kind, name, ".py")
        spec = importlib.util.spec_from_file_location(
            f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    workload: dict
    traffic: object
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, object]


def load_bench(path: Path = REPO / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())


def reports(metric: dict, cell: str, bench: dict) -> bool:
    """Whether ``cell`` reports ``metric``: its ``workloads`` list, or, for
    a per-layer metric without one, every cell reporting what it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        moved = next(m for m in bench["end_to_end"] if m["name"] == metric["moves"])
        return reports(moved, cell, bench)
    return True


def load_cell(name: str, bench: dict, registry: Registry = Registry()) -> Cell:
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = registry.json("configs", entry["config"])
    e2e = [m for m in bench["end_to_end"] if reports(m, name, bench)]
    per_layer = [m for m in bench["per_layer"] if reports(m, name, bench)]
    return Cell(name=name, chips=int(entry["chips"]), config=config,
                workload=registry.json("workloads", name),
                traffic=registry.module("traffic", entry["traffic"]),
                end_to_end=e2e, per_layer=per_layer,
                readers={m["name"]: registry.module("metrics", m["name"])
                         for m in per_layer})


def process_start() -> float:
    """The epoch seconds at which this process started (Linux)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


def forbidden_loaded() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"not read ({e})"


def traced(session, seconds: float, device, log=print):
    """The traced run's three parts; returns the Trace."""
    import torch
    from pose_splatter_torch.utils import stages

    from benchmark import compare, trace as T

    kind = session.kind
    tr = T.Trace(spec=session.spec)
    torch.cuda.synchronize(device)
    t0, n = time.perf_counter(), 0
    while time.perf_counter() - t0 < MFU_SHARE * seconds:
        session.unit()
        n += 1
    session.finish()
    torch.cuda.synchronize(device)
    tr.mfu_seconds = time.perf_counter() - t0
    tr.mfu_flops = float(session.flops_per_unit) * n

    def marked_unit():
        stages.mark("unit")
        session.unit()

    log(f"traced: {n} plain units in {tr.mfu_seconds:.3f} s")
    t1 = time.perf_counter()
    with stages.record(device) as rec:
        tr.marked = T.profile(marked_unit, MARKED_UNITS[kind], device)
        session.finish()
    log(f"traced: marked units profiled and read in {time.perf_counter() - t1:.3f} s")
    tr.stages = {k: v for k, v in rec.spans.items() if k != "unit"}
    tr.values = rec.values
    tr.calls = T.compositor_calls(tr.marked)
    tr.bounds = compare.compositor_bounds(rec.values, session.spec)
    t1 = time.perf_counter()
    tr.profile = T.profile(session.unit, PROFILED_UNITS[kind], device)
    session.finish()
    log(f"traced: units profiled and read in {time.perf_counter() - t1:.3f} s")
    for b in rec.values.get("binning", []):
        log(f"binning overflow a call: {int(b.overflow)} rows dropped "
            f"of {int(b.counts.long().sum()) + int(b.overflow)}")
    for k, v in tr.calls.items():
        log(f"{k}: {len(v)} calls profiled, device s {v}; "
            f"least s {tr.bounds.get(k)}")
    return tr


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: dict, breakdown: Optional[dict] = None) -> str:
    out = dict(correct=bool(correct), attempted=int(attempted),
               failed=int(failed), metrics=metrics, device=device)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=print) -> dict:
    """Set-up, window or traced run, then the comparison with the
    reference. Returns the result's parts (``result_line`` keywords)."""
    import torch

    session = cell.traffic.Session(cell, seed, device)
    setup_s = time.time() - t_start
    cuda = torch.device(device).type == "cuda"
    metrics, breakdown = {}, None
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(device) if cuda else "cpu",
               count=cell.chips)
    if trace:
        tr = traced(session, seconds, device, log)
        for m in cell.per_layer:
            value = cell.readers[m["name"]].read(tr)
            if value is not None:
                metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
        dev.update(busy_s=tr.profile.busy_s, window_s=tr.profile.window_s)
        t1 = time.perf_counter()
        breakdown = dict(device_ops=tr.profile.top_ops(),
                         idle_gaps=tr.profile.idle_by_host())
        log(f"breakdown read in {time.perf_counter() - t1:.3f} s")
    else:
        e2e = session.window(seconds)
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = dict(value=float(e2e[m["name"]]),
                                          unit=m["unit"])
    dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    session.release()
    attempted, failed = session.attempted, session.failed
    log(f"setup_s {setup_s}; attempted {attempted}; failed {failed}")
    t1 = time.perf_counter()
    checks = session.check()
    log(f"reference and checks: {time.perf_counter() - t1:.3f} s")
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    return dict(correct=correct, attempted=attempted, failed=failed,
                metrics=metrics, device=dev, checks=checks, breakdown=breakdown)


def main(argv=None) -> int:
    t_start = process_start()
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # Build and kernel caches at fixed paths inside the checkout.
    cache = REPO / "build" / "bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "nv"))
    os.environ["USE_FLAX"] = "0"
    import torch

    bench = load_bench()
    cell = load_cell(args.workload, bench)
    import pose_splatter_torch  # noqa: F401  (the system under test, or no run)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"error: {cell.name} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    log = lambda s: print(s, flush=True)  # noqa: E731
    log(f"card: {card_line()}")
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                   t_start, log)
    found = forbidden_loaded()
    if found:
        print(f"error: the run loaded {found}", file=sys.stderr)
        return 3
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(result_line(**res), flush=True)
    return 0
