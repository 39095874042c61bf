"""Per-stage timing of the eval forward, off unless a caller records.

The forward marks the end of each of its stages with :func:`mark`. Inside
``with record() as rec:`` every mark synchronises the device, adds the host
time since the previous mark to ``rec.ms[name]`` and keeps the value passed
with it in ``rec.values[name]``. Outside a recording a mark costs one check.
Stage spans end in a synchronize, so recorded runs are slower than plain
ones; time the whole forward without recording.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, Optional

import torch


class Recording:
    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.ms: Dict[str, float] = {}
        self.values: Dict[str, Any] = {}
        self._t = time.perf_counter()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark(self, name: str, value: Any = None):
        self._sync()
        now = time.perf_counter()
        self.ms[name] = self.ms.get(name, 0.0) + 1e3 * (now - self._t)
        self._t = now
        if value is not None:
            self.values[name] = value


_active: Optional[Recording] = None


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
