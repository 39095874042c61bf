"""What a traced run reads: stage marks, the profiler's device timeline,
and the compositor calls in it.

Stage times are the program's own marks (``utils/stages.py``): inside a
recording each mark synchronises the device and closes the stage that
began at the previous mark, so marks are read only over units recorded
for them, never in a timed window. The device timeline comes from
``torch.profiler`` (CUPTI), exported as a Chrome trace into the run's
temporary directory and read back.
"""

from __future__ import annotations

import json
import os
import statistics
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

from benchmark import counts

DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")


@dataclass
class Event:
    name: str
    start: float  # seconds, profiler clock
    dur: float    # seconds


@dataclass
class Profile:
    """One profiled stretch of ``units`` units."""

    device: List[Event]
    host: List[Event]
    window_s: float
    units: int

    @property
    def busy_s(self) -> float:
        """Seconds in which some device operation ran (the union)."""
        total, end = 0.0, None
        for ev in sorted(self.device, key=lambda e: e.start):
            lo, hi = ev.start, ev.start + ev.dur
            if end is None or lo > end:
                total += hi - lo
                end = hi
            elif hi > end:
                total += hi - end
                end = hi
        return total

    def gaps(self) -> List[Tuple[float, float]]:
        """Intervals between device operations, in order."""
        out, end = [], None
        for ev in sorted(self.device, key=lambda e: e.start):
            if end is not None and ev.start > end:
                out.append((end, ev.start))
            end = max(end or ev.start, ev.start + ev.dur)
        return out

    def top_ops(self, n: int = 10) -> List[list]:
        """The device operations that took the most time, summed by name."""
        by: Dict[str, float] = {}
        for ev in self.device:
            key = ev.name[:160]
            by[key] = by.get(key, 0.0) + ev.dur
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_host(self, n: int = 10) -> List[list]:
        """Idle device time summed by the host operation that overlapped
        each gap most (the innermost on a tie)."""
        import numpy as np

        gaps = np.asarray(self.gaps(), dtype=np.float64).reshape(-1, 2)
        by: Dict[str, float] = {}
        if not len(gaps):
            return []
        starts = np.asarray([e.start for e in self.host])
        durs = np.asarray([e.dur for e in self.host])
        names = [e.name[:120] for e in self.host]
        for c in range(0, len(gaps), 128):
            lo, hi = gaps[c:c + 128, :1], gaps[c:c + 128, 1:]
            if len(starts):
                ov = np.minimum(hi, starts + durs) - np.maximum(lo, starts)
                # The largest overlap; among equal ones the shortest event.
                key = np.where(ov > 0, ov - 1e-12 * durs, -np.inf)
                best = np.argmax(key, axis=1)
                found = np.isfinite(key[np.arange(len(lo)), best])
            else:
                best, found = np.zeros(len(lo), int), np.zeros(len(lo), bool)
            for (a, b), j, ok in zip(gaps[c:c + 128], best, found):
                k = "host: " + (names[j] if ok else "python")
                by[k] = by.get(k, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def profile(run_unit: Callable[[], None], units: int, device) -> Profile:
    """Run ``units`` units under ``torch.profiler`` (CPU and CUDA
    activities) and read the trace back."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize(device)
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            run_unit()
        torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    dev, host = [], []
    for ev in data.get("traceEvents", []):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        e = Event(str(ev.get("name", "")), float(ev["ts"]) * 1e-6,
                  float(ev["dur"]) * 1e-6)
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append(e)
        elif cat in ("cpu_op", "cuda_runtime", "cuda_driver"):
            host.append(e)
    return Profile(device=dev, host=host, window_s=window, units=units)


def _family(name: str) -> Optional[str]:
    for fam, names in counts.KERNELS.items():
        if any(k in name for k in names):
            return fam
    return None


def _call_part(ev: Event) -> bool:
    low = ev.name.lower()
    return (_family(ev.name) is not None
            or any(k in ev.name for k in counts.SHARED_KERNELS)
            or "memset" in low or "fill" in low)


def compositor_calls(prof: Profile) -> Dict[str, List[float]]:
    """Device seconds of each compositor call in a profile, by kernel:
    each maximal run of consecutive device operations made of the
    compositor's kernels, the chunk map, memsets and fills, holding at
    least one of the compositor's own kernels."""
    out: Dict[str, List[float]] = {k: [] for k in counts.KERNELS}
    run: List[Event] = []

    def close():
        fams = {_family(e.name) for e in run} - {None}
        if len(fams) == 1:
            out[fams.pop()].append(sum(e.dur for e in run))
        run.clear()

    for ev in sorted(prof.device, key=lambda e: e.start):
        if _call_part(ev):
            fam = _family(ev.name)
            if fam is not None and run and ({_family(e.name) for e in run}
                                            - {None, fam}):
                close()
            run.append(ev)
        else:
            close()
    close()
    return out


@dataclass
class Trace:
    """Everything a per-layer reader may read."""

    spec: object
    stages: Dict[str, List[float]] = field(default_factory=dict)
    values: Dict[str, list] = field(default_factory=dict)
    marked: Optional[Profile] = None
    profile: Optional[Profile] = None
    bounds: Dict[str, List[float]] = field(default_factory=dict)
    calls: Dict[str, List[float]] = field(default_factory=dict)
    mfu_flops: float = 0.0
    mfu_seconds: float = 0.0

    def stage_ms(self, name: str) -> Optional[float]:
        spans = self.stages.get(name)
        return statistics.median(spans) if spans else None

    def roofline(self, kernel: str) -> Optional[float]:
        """Sum of the calls' least seconds over the same calls' device
        seconds, in percent; None where the calls cannot be matched."""
        bounds, calls = self.bounds.get(kernel, []), self.calls.get(kernel, [])
        if not bounds or len(bounds) != len(calls) or sum(calls) <= 0:
            return None
        return 100.0 * sum(bounds) / sum(calls)
