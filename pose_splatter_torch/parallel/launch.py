"""Start N ranks of a command on the CPU and wait for them.

It stands in for the JAX package's virtual devices
(``--xla_force_host_platform_device_count``) in the tests and in the
scripts' ``--virtual N``: each child is ``python <argv>`` with
``MASTER_ADDR`` / ``MASTER_PORT`` (a free port on 127.0.0.1),
``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` set, pinned to ``threads``
threads, and :func:`~pose_splatter_torch.parallel.multihost.
initialize_distributed` forms the gloo group from them. A rank that exits
with an error stops the others (they would wait on it for ever), and so
does the time limit.

    results = launch(2, ["-m", "pose_splatter_torch.scripts.scaling",
                         "--device", "cpu"], timeout=300)
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence

ROOT = Path(__file__).resolve().parents[2]


class RankResult(NamedTuple):
    rank: int
    returncode: int  # a rank the launcher stopped has a negative code
    output: str  # stdout and stderr


class LaunchError(RuntimeError):
    """A rank failed, or the ranks outlived the time limit."""

    def __init__(self, message: str, results: List[RankResult]):
        super().__init__(message)
        self.results = results


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(n: int, argv: Sequence[str], timeout: float = 300.0,
           env: Optional[Dict[str, str]] = None, threads: int = 1,
           check: bool = True) -> List[RankResult]:
    """Run ``python argv`` as ranks 0..n-1 of one group; return each rank's
    exit code and output. With ``check`` a rank that fails (or the time
    limit) raises :class:`LaunchError` after every rank has stopped."""
    port = free_port()
    base = dict(os.environ, **(env or {}))
    base["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in base.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        base[var] = str(threads)
    procs, logs = [], []
    try:
        for r in range(n):
            e = dict(base, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                     WORLD_SIZE=str(n), RANK=str(r), LOCAL_RANK=str(r))
            log = tempfile.TemporaryFile(mode="w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, *argv], stdout=log,
                stderr=subprocess.STDOUT, env=e, cwd=str(ROOT)))
        deadline = time.monotonic() + timeout
        timed_out = False
        while True:
            codes = [p.poll() for p in procs]
            if None not in codes or any(c not in (None, 0) for c in codes):
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
    finally:
        killed = set()
        for r, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
                killed.add(r)
            p.wait()
    results = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        results.append(RankResult(r, p.returncode, log.read()))
        log.close()
    # The rank that failed first, not one the launcher stopped after it.
    bad = [res for res in results
           if res.returncode != 0 and res.rank not in killed]
    if check and (bad or timed_out):
        why = (f"ranks outlived the {timeout:.0f} s limit" if timed_out
               else f"rank {bad[0].rank} exited with {bad[0].returncode}")
        tails = "\n".join(f"--- rank {res.rank} (exit {res.returncode}):\n"
                          f"{res.output[-3000:]}" for res in results)
        raise LaunchError(f"{why}\n{tails}", results)
    return results


def is_rank() -> bool:
    """True in a process that a launcher started as one rank of a group."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ
