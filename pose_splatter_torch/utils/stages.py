"""Stage spans of the train step and the forward, the program's count of
its own blocking reads of the device, and the synchronising recording.

**Units and spans.** A unit is one train step (``step``,
``make_train_step``'s ``train_step``), one forward outside a step
(``frame``, ``PoseSplatter.forward``), one K-step call (``multi_step``,
``MultiStep``) or one frame of the visual-pose features (``features``,
``preprocess/visual_features.py``: the stages of a forward, then
``resnet`` and ``sh``). Inside a unit each stage is a span with its own start and
end, a parent and the unit's id: ``frame`` (a forward inside a step) with
``carve``, ``unets``, ``select_head``, ``binning`` (with the projection
and depth sort in 3D), ``kernel`` and ``untile``; then ``loss``,
``loss_bwd`` (autograd down to the compositor's backward), ``kernel_bwd``,
``backward`` (autograd below the renderer) and ``optimizer``; and ``sync``
around every blocking read of the device (:func:`blocking`). Spans are kept
while

- ``with stages.trace(device):`` is active, the operator's switch for a
  long training run or a served recording; or
- a ``torch.profiler`` session records. Each span is then also a range
  ``pose_splatter/<name>`` (as ``record_function`` makes one), so the
  profiler's trace (``utils/profiling.trace``, ``scripts/profile.py
  --trace``, opened in TensorBoard or Perfetto) shows the stages beside the
  kernels they launched, on the device trace's clock.

Neither synchronises. A traced stretch starts with one synchronise, an
anchor event and the anchor's host time; from then on each boundary
records a timing CUDA event on the current stream and the host's
``perf_counter``, and nothing reads the device until the record is read.
:func:`last_trace` resolves the most recent stretch: for each unit its
spans (host start and end in ms from the anchor, device ms, and ``lag``:
the device's time at the span's end, on the host clock, minus the host's;
a stage that ends with ``lag`` near 0 is one in which the device waited
for the host's launches) and its counters. Units are kept in a ring of
:data:`RING_UNITS`. Inside a CUDA graph capture nothing is recorded: a
K-step call's replays are one ``multi_step`` span. With no trace,
profiler or recording active, a boundary costs one check: no event, no
clock read, no allocation.

**Counters**, a unit: ``host_syncs``, the blocking reads of the device the
program made (counted always, process-wide in :data:`host_syncs`);
``sync_wait_ms``, the host ms blocked in them (the ``sync`` spans, while
tracing); the binning's rows kept and dropped, and its Gaussians binned
and those whose tile span it clamped, a record a call (:func:`binned`;
device tensors until the record is read); the
selection's voxels above its final threshold and Gaussians kept, a record
a call (:func:`selected`; device tensors until read); the largest
``allocated_bytes`` of the CUDA caching allocator seen at the unit's span
boundaries (a host statistic: no synchronise, and the allocator's peak
statistics are never reset); and the compositors' launches, the
difference of each counter registered with :func:`count_launches` across
the unit.

**Recording.** Inside ``with record() as rec:`` every span end and every
bare :func:`mark` synchronises the device, appends the host time since the
previous mark to ``rec.spans[name]`` and the value passed with it to
``rec.values[name]``. Recorded runs are slower than plain ones; units run
under a recording are flagged synchronised and :func:`last_trace` leaves
them out.

    with stages.trace("cuda"):
        for batch in batches:
            state, metrics = train_step(state, batch)
    t = stages.last_trace()
    t.stage_ms("backward"), t.median("sync_wait_ms"), t.units[-1]["spans"]
"""

from __future__ import annotations

import itertools
import statistics
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _profiler

RING_UNITS = 1024
RANGE_PREFIX = "pose_splatter/"
# A profiler range as ``record_function`` makes it, at a tenth of its cost.
_range = getattr(torch._C._profiler, "_RecordFunctionFast",
                 _profiler.record_function)

# Blocking reads of the device made through :func:`blocking` (always on).
host_syncs = 0


# -- the synchronising recording ---------------------------------------------

class Recording:
    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.spans: Dict[str, List[float]] = {}
        self.values: Dict[str, List[Any]] = {}
        self._t = time.perf_counter()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark(self, name: str, value: Any = None):
        self._sync()
        now = time.perf_counter()
        self.spans.setdefault(name, []).append(1e3 * (now - self._t))
        self._t = now
        if value is not None:
            self.values.setdefault(name, []).append(value)


_active: Optional[Recording] = None


def recording() -> bool:
    """Whether a :func:`record` block is active."""
    return _active is not None


def mark(name: str, value: Any = None):
    """A recording's mark with no span: the end of stage ``name``;
    ``value`` is kept while recording."""
    if _active is not None:
        _active.mark(name, value)


@contextmanager
def record(device="cuda") -> Iterator[Recording]:
    """Record the stage marks made inside the block (not re-entrant)."""
    global _active
    if _active is not None:
        raise RuntimeError("a stage recording is already active")
    rec = Recording(device)
    rec._sync()
    rec._t = time.perf_counter()
    _active = rec
    try:
        yield rec
    finally:
        _active = None


# -- spans -------------------------------------------------------------------

class _Stretch:
    """A traced stretch: its device and the anchor of its clock."""

    __slots__ = ("device", "event", "host", "streams")

    def __init__(self, device):
        self.device = torch.device(device)
        self.event = None
        self.streams: Dict[int, torch.cuda.Stream] = {}
        if self.device.type == "cuda":
            self.device = torch.device("cuda", self.device.index
                                       if self.device.index is not None
                                       else torch.cuda.current_device())
            torch.cuda.synchronize(self.device)
            self.event = _event()
            self.event.record(self.stream())
        self.host = time.perf_counter()

    def stream(self) -> torch.cuda.Stream:
        """The device's current stream, found by its handle: building the
        Stream object, as ``Event.record()`` does each call, costs twice the
        record itself."""
        raw = torch._C._cuda_getCurrentRawStream(self.device.index)
        s = self.streams.get(raw)
        if s is None:
            s = self.streams[raw] = torch.cuda.current_stream(self.device)
        return s


class _Span:
    __slots__ = ("name", "parent", "t0", "t1", "e0", "e1", "range")

    def __init__(self, name: str, parent: int):
        self.name, self.parent = name, parent
        self.t1 = self.e1 = self.range = None


class _Unit:
    __slots__ = ("id", "stretch", "synced", "spans", "open", "events",
                 "syncs", "launches", "binning", "selection", "allocated")

    def __init__(self, stretch: Optional[_Stretch], synced: bool):
        self.id = next(_ids)
        self.stretch, self.synced = stretch, synced
        self.spans: List[_Span] = []
        self.open: List[int] = []
        self.events: list = []
        self.syncs = host_syncs
        self.launches = {k: f.launches for k, f in _launch_counters.items()}
        self.binning: list = []
        self.selection: list = []
        self.allocated: Optional[int] = None


_unit: Optional[_Unit] = None       # the open unit: what every boundary checks
_trace: Optional[_Stretch] = None   # the stretch of an active trace()
_pstretch: Optional[_Stretch] = None  # the stretch of the profiled units
_ring: deque = deque(maxlen=RING_UNITS)
_pool: list = []                    # timing events of units that left the ring
_ids = itertools.count()
_launch_counters: Dict[str, Callable] = {}


def _event():
    return _pool.pop() if _pool else torch.cuda.Event(enable_timing=True)


def _capturing() -> bool:
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


def _allocated(device: torch.device) -> Optional[int]:
    """Bytes the CUDA caching allocator holds in tensors on ``device`` (its
    host-side statistic, read without waiting for the device); None off
    CUDA."""
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats_as_nested_dict(device)
    return stats["allocated_bytes"]["all"]["current"]


def _stamp(u: _Unit):
    e = None
    st = u.stretch
    if st is not None:
        if st.event is not None:
            e = _event()
            e.record(st.stream())
            u.events.append(e)
        a = _allocated(st.device)
        if a is not None:
            u.allocated = max(a, u.allocated or 0)
    return time.perf_counter(), e


def _begin(name: str, at=None):
    u = _unit
    if _capturing():
        return
    sp = _Span(name, u.open[-1] if u.open else -1)
    if _profiler._is_profiler_enabled:
        sp.range = _range(RANGE_PREFIX + name)
        sp.range.__enter__()
    sp.t0, sp.e0 = at or _stamp(u)
    u.open.append(len(u.spans))
    u.spans.append(sp)


def _close(name: str):
    """Close the innermost open span ``name`` and any left open inside it;
    returns the boundary, or None where no such span is open."""
    global _unit
    u = _unit
    if _capturing():
        return None
    for i in range(len(u.open) - 1, -1, -1):
        if u.spans[u.open[i]].name == name:
            break
    else:
        return None
    at = _stamp(u)
    for j in reversed(u.open[i:]):
        sp = u.spans[j]
        sp.t1, sp.e1 = at
        if sp.range is not None:
            sp.range.__exit__(None, None, None)
    del u.open[i:]
    if not u.open:
        u.syncs = host_syncs - u.syncs
        u.launches = {k: f.launches - u.launches[k]
                      for k, f in _launch_counters.items()}
        if len(_ring) == _ring.maxlen:
            _pool.extend(_ring[0].events)
        _ring.append(u)
        _unit = None
    return at


def _open_unit(name: str):
    global _unit, _pstretch
    if _capturing():
        return
    stretch = None
    if _active is not None:
        _pstretch = None  # a synchronised unit ends a profiled stretch
    elif _trace is not None:
        stretch = _trace
    else:
        if _pstretch is None:
            _pstretch = _Stretch("cuda" if torch.cuda.is_initialized()
                                 else "cpu")
        stretch = _pstretch
    _unit = _Unit(stretch, synced=_active is not None)
    _begin(name)


class Scope:
    """``with Scope("frame"):`` a unit's root span, or inside an open unit
    a span of that name. Make one a call site, once."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _pstretch
        if _unit is not None:
            _begin(self.name)
        elif (_active is not None or _trace is not None
              or _profiler._is_profiler_enabled):
            _open_unit(self.name)
        elif _pstretch is not None:
            _pstretch = None  # a plain unit ends a profiled stretch

    def __exit__(self, *exc):
        if _unit is not None:
            _close(self.name)
        return False


def begin(name: str):
    """Start of stage ``name`` inside the open unit."""
    if _unit is not None:
        _begin(name)


def end(name: str, value: Any = None, then: Optional[str] = None):
    """End of stage ``name`` (the recording's mark, with ``value``); with
    ``then``, stage ``then`` starts at the same boundary."""
    if _unit is not None or _active is not None:
        if _active is not None:
            _active.mark(name, value)
        if _unit is not None:
            at = _close(name)
            if then is not None and _unit is not None:
                _begin(then, at)


def blocking(read: Callable, *args, **kwargs):
    """``read(*args, **kwargs)``, a call that waits for the device: counted
    in :data:`host_syncs`; inside a unit, a ``sync`` span."""
    global host_syncs
    host_syncs += 1
    if _unit is None:
        return read(*args, **kwargs)
    _begin("sync")
    try:
        return read(*args, **kwargs)
    finally:
        if _unit is not None:
            _close("sync")


def to_device(x, device: torch.device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(x, dtype, device)``. A host value's copy to a CUDA
    device waits for the device's queue, so it goes through
    :func:`blocking`."""
    if device.type == "cuda" and not (torch.is_tensor(x) and x.is_cuda):
        return blocking(torch.as_tensor, x, dtype=dtype, device=device)
    return torch.as_tensor(x, dtype=dtype, device=device)


def binned(counts: torch.Tensor, overflow: torch.Tensor,
           span: Optional[torch.Tensor] = None, expand: Optional[int] = None):
    """A binning call's record: rows binned a tile, rows dropped, and each
    Gaussian's tile span with the ``expand`` it was clamped to (counted
    when the record is read: the Gaussians binned and those clamped)."""
    if _unit is not None:
        _unit.binning.append((counts, overflow, span, expand))


def selected(values: torch.Tensor, threshold: torch.Tensor,
             valid: torch.Tensor):
    """A selection call's record: the values above its final threshold
    (over every voxel) and the Gaussians it kept, counted on the device
    only inside an open unit and outside a CUDA graph capture."""
    if _unit is not None and not _capturing():
        with torch.no_grad():
            _unit.selection.append(torch.stack(
                [(values > threshold).sum(), valid.sum()]))


def count_launches(name: str, fn: Callable):
    """Report the change of ``fn.launches`` across each unit as
    ``launches[name]``."""
    _launch_counters[name] = fn


@contextmanager
def trace(device="cuda") -> Iterator[None]:
    """Keep the spans of the units run inside the block (not re-entrant);
    read them with :func:`last_trace`."""
    global _trace
    if _trace is not None:
        raise RuntimeError("a stage trace is already active")
    _trace = _Stretch(device)
    try:
        yield
    finally:
        _trace = None


# -- reading the record ------------------------------------------------------

class StageTrace:
    """The resolved units of one traced stretch (see the module's
    docstring); ``units`` in order, each a dict."""

    def __init__(self, units: List[_Unit]):
        st = units[0].stretch
        if st.event is not None:
            torch.cuda.synchronize(st.device)
        self.units = [self._resolve(u, st) for u in units]

    @staticmethod
    def _resolve(u: _Unit, st: _Stretch) -> dict:
        spans = []
        for sp in u.spans:
            host_ms = 1e3 * (sp.t1 - sp.t0)
            if st.event is not None:
                device_ms = sp.e0.elapsed_time(sp.e1)
                lag = st.event.elapsed_time(sp.e1) - 1e3 * (sp.t1 - st.host)
            else:  # the CPU runs each operation as the host issues it
                device_ms, lag = host_ms, 0.0
            spans.append(dict(name=sp.name, parent=sp.parent, unit=u.id,
                              start_ms=1e3 * (sp.t0 - st.host),
                              end_ms=1e3 * (sp.t1 - st.host),
                              host_ms=host_ms, device_ms=device_ms,
                              lag_ms=lag))
        kept = sum(int(b[0].long().sum()) for b in u.binning)
        dropped = sum(int(b[1]) for b in u.binning)
        clamped = [int((b[2] > b[3]).sum()) for b in u.binning if b[2] is not None]
        gaussians = [int((b[2] > 0).sum()) for b in u.binning if b[2] is not None]
        sel = [[int(x) for x in s.tolist()] for s in u.selection]
        return dict(id=u.id, name=u.spans[0].name, spans=spans,
                    host_syncs=u.syncs,
                    sync_wait_ms=sum(s["host_ms"] for s in spans
                                     if s["name"] == "sync"),
                    launches=dict(u.launches), binning_calls=len(u.binning),
                    binned_rows=kept, dropped_rows=dropped,
                    binned_gaussians=sum(gaussians) if gaussians else None,
                    clamped_gaussians=sum(clamped) if clamped else None,
                    selection_calls=len(sel),
                    above_threshold=sum(a for a, _ in sel) if sel else None,
                    gaussians_live=sum(n for _, n in sel) if sel else None,
                    max_allocated_bytes=u.allocated)

    def stage_ms(self, name: str) -> Optional[float]:
        """Median over the units holding span ``name`` of its device ms
        a unit."""
        per = [sum(s["device_ms"] for s in u["spans"] if s["name"] == name)
               for u in self.units
               if any(s["name"] == name for s in u["spans"])]
        return statistics.median(per) if per else None

    def median(self, counter: str) -> Optional[float]:
        """Median over the units of a unit's counter (units where it is
        None, as the selection's where no selection ran, left out)."""
        vals = [u[counter] for u in self.units if u[counter] is not None]
        return statistics.median(vals) if vals else None


def last_trace() -> Optional[StageTrace]:
    """The most recent stretch of units that were not synchronised, read
    (this waits for the device), or None."""
    units = [u for u in _ring if not u.synced]
    if not units:
        return None
    st = units[-1].stretch
    return StageTrace([u for u in units if u.stretch is st])
