"""Per-stage timing of the forward and the train step, off unless a caller
records.

The forward, the compositor's backward and the train step mark the end of
each of their stages with :func:`mark`. Inside ``with record() as rec:``
every mark synchronises the device, appends the host time since the
previous mark to ``rec.spans[name]`` (and adds it to ``rec.ms[name]``) and
appends the value passed with it to ``rec.values[name]``. Outside a
recording a mark costs one check. Stage spans end in a synchronize, so
recorded runs are slower than plain ones; time whole runs without
recording.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

import torch


class Recording:
    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.ms: Dict[str, float] = {}
        self.spans: Dict[str, List[float]] = {}
        self.values: Dict[str, List[Any]] = {}
        self._t = time.perf_counter()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark(self, name: str, value: Any = None):
        self._sync()
        now = time.perf_counter()
        span = 1e3 * (now - self._t)
        self.ms[name] = self.ms.get(name, 0.0) + span
        self.spans.setdefault(name, []).append(span)
        self._t = now
        if value is not None:
            self.values.setdefault(name, []).append(value)


_active: Optional[Recording] = None


def recording() -> bool:
    """Whether a :func:`record` block is active."""
    return _active is not None


def mark(name: str, value: Any = None):
    """End of stage ``name``; ``value`` is kept while recording."""
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
