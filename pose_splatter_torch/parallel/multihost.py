"""Process-group initialisation, per-rank frame loading, the global batch
and the scaling harness (counterpart of
``pose_splatter_tpu/parallel/multihost.py``).

Every rank runs the same program (one rank a device) and calls
:func:`initialize_distributed`; a ``data`` mesh spans all ranks; each rank
loads only its own frames (:func:`process_local_indices`, process-strided
as in the JAX package) and keeps them on its device
(:func:`assemble_global_batch`); the data-parallel step
(``parallel/sharding.py``) averages the gradients.

Deviation from the JAX package: the address, the world size and the rank
come from PyTorch's variables ``MASTER_ADDR`` / ``MASTER_PORT``,
``WORLD_SIZE`` and ``RANK`` where the JAX package reads
``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``.
The backend follows the device: NCCL for ``cuda``, gloo for ``cpu``.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import time
from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from pose_splatter_torch.parallel.launch import free_port, is_rank
from pose_splatter_torch.parallel.mesh import Mesh, make_mesh, world
from pose_splatter_torch.utils.device import resolve_device

INIT_TIMEOUT_S = 60.0


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
    timeout: float = INIT_TIMEOUT_S,
) -> torch.device:
    """Initialise the default process group and return this rank's device.

    ``coordinator_address`` ("host:port"), ``num_processes`` and
    ``process_id`` fall back to ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``
    and ``RANK``. With no coordinator and one process (or none given) it
    initialises nothing, as the JAX function does. The backend is NCCL on a
    ``cuda`` device (this rank's card is ``LOCAL_RANK``, else 0, unless
    ``device`` names one) and gloo on ``cpu``; a ``cuda`` device without a
    GPU raises, and so does a group that does not form within
    ``timeout`` seconds: nothing falls back to another backend or device.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None and num_processes in (None, 1):
        return dev  # single-process run
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator address, "
                         "the number of processes and this process's id")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(device_id=dev) if dev.type == "cuda" else {}
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout), **kw)
    return dev


@contextlib.contextmanager
def process_group(device: Union[str, torch.device] = "cuda"):
    """The process group an entry point runs in, and this rank's device:
    the launcher's (from the environment, :func:`initialize_distributed`)
    in a process it started, else a group of one rank on a free local port
    (NCCL on the card, gloo on the CPU), so that one rank runs the same
    collectives as many. A group formed here is destroyed on exit; one
    that already exists is used as it is."""
    if dist.is_initialized():
        yield resolve_device(device)
        return
    if is_rank():
        dev = initialize_distributed(device=device)
    else:
        dev = initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                                     device=device)
    try:
        yield dev
    finally:
        dist.destroy_process_group()


def process_local_indices(
    order: np.ndarray,
    batch_size: int,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> np.ndarray:
    """This process's stride of a (shuffled) global frame order.

    ``order`` is the identical global permutation on every process (same
    seed); the global batch is ``batch_size`` frames of which this process
    materializes ``batch_size / process_count`` — positions
    ``p::process_count`` within each batch window, so any global batch is
    the disjoint union of the per-process slices. The defaults are this
    rank and the world size (0 and 1 without a process group).
    """
    if process_index is None:
        process_index = world()[0]
    if process_count is None:
        process_count = world()[1]
    if batch_size % process_count:
        raise ValueError(
            f"global batch {batch_size} not divisible by "
            f"{process_count} processes")
    n_batches = len(order) // batch_size
    windows = order[: n_batches * batch_size].reshape(n_batches, batch_size)
    return windows[:, process_index::process_count].reshape(-1)


def assemble_global_batch(local_batch: Dict[str, Any], mesh: Mesh,
                          batch_axis: str = "data") -> Dict[str, torch.Tensor]:
    """This rank's part of the global batch, on its device: ``local_batch``
    (leading axis ``global_batch / ranks``) as tensors on the current CUDA
    device under NCCL, else on the CPU. No rank sends anything: the
    data-parallel step takes each rank's slice as it is."""
    if mesh.coords is None:
        raise RuntimeError("this rank is not in the mesh")
    nccl = dist.is_initialized() and dist.get_backend() == "nccl"
    device = (torch.device("cuda", torch.cuda.current_device()) if nccl
              else torch.device("cpu"))
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in local_batch.items()}


def global_mesh(batch_axis: str = "data") -> Mesh:
    """1-D mesh over every rank of the group."""
    return make_mesh(axis_names=(batch_axis,))


# ----------------------------------------------------------------------------
# Scaling harness.
# ----------------------------------------------------------------------------

def _sync(tree) -> None:
    """Wait for the card's queue if anything in ``tree`` lives on it."""
    leaves = tree.values() if isinstance(tree, dict) else [tree]
    for x in leaves:
        if torch.is_tensor(x) and x.is_cuda:
            torch.cuda.synchronize(x.device)
            return


def measure_steps_per_s(step_fn, state, batch, iters: int = 10) -> float:
    """Wall-clock steps/s of a train step after one warm-up step; the card
    is synchronised before the clock starts and before it stops."""
    state, metrics = step_fn(state, batch)
    _sync(metrics)
    t0 = time.perf_counter()
    for _ in range(iters):
        state, metrics = step_fn(state, batch)
    _sync(metrics)
    return iters / (time.perf_counter() - t0)


def _concat(batch: Dict[str, torch.Tensor], n: int) -> Dict[str, torch.Tensor]:
    return {k: torch.cat([v] * n, 0) for k, v in batch.items()}


def scaling_report(make_step_and_inputs: Callable, device_counts:
                   Optional[Sequence[int]] = None,
                   spmd_baseline: bool = False) -> Dict[str, Any]:
    """steps/s and scaling efficiency across rank counts (the JAX
    function's rows and keys; "devices" here are ranks).

    ``make_step_and_inputs(ranks) -> (step_fn, state, batch)`` builds a
    data-parallel step over a mesh of exactly those ranks with this rank's
    share of a batch that grows with the count (weak scaling). Every rank
    calls it for every count (building a mesh is collective); the ranks
    in the mesh time the step, the others wait. ``efficiency`` is global
    frames/s against perfect linear scaling of the first count's rate.
    ``spmd_baseline`` adds ``spmd_efficiency``: the time of the first rank
    stepping the same global batch alone divided by the n-rank step time.
    Rank 0's rows are returned on every rank.
    """
    rank, size = world()
    if device_counts is None:
        device_counts = [1]
        while device_counts[-1] * 2 <= size:
            device_counts.append(device_counts[-1] * 2)
    rows = []
    base = None
    for n in device_counts:
        ranks = list(range(n))
        step_fn, state, batch = make_step_and_inputs(ranks)
        if rank < n:
            sps = measure_steps_per_s(step_fn, state, batch)
        if spmd_baseline and n > 1:
            # The same global batch on ONE rank.
            step1, state1, batch1 = make_step_and_inputs(ranks[:1])
            if rank == 0:
                sps1 = measure_steps_per_s(step1, state1, _concat(batch1, n))
        if dist.is_initialized():
            dist.barrier()
        if rank != 0:
            continue
        frames = sps * n  # weak scaling: batch grows with n
        if base is None:
            base = frames
        row = {
            "devices": n,
            "steps_per_s": round(sps, 4),
            "frames_per_s": round(frames, 4),
            "efficiency": round(frames / (base * n / device_counts[0]), 4),
        }
        if spmd_baseline and n > 1:
            row["spmd_efficiency"] = round(sps / sps1, 4)
        rows.append(row)
    report = {"rows": rows}
    if dist.is_initialized():
        box = [report]
        dist.broadcast_object_list(box, src=0)
        report = box[0]
    return report
