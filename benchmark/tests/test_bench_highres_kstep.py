"""The cells ``train-2d-highres`` and ``train-2d-kstep`` and the readers
``gaussians_live.train`` and ``live_memory_gb.train``, on the CPU at the
tiny size: the K-step session's checked calls followed step by step by
the reference, its window counted in steps, its traced run (eager steps
inside ``stages.record()``) with no failed unit; the high-res cell's
traced run reporting the selection record; and both readers silent on a
program without the records."""

import math
import types

import pytest
import torch

from benchmark import harness

BENCH = harness.load_bench()
NEW_METRICS = ["gaussians_live.train", "live_memory_gb.train"]


def _metric(name):
    return next(m for m in BENCH["per_layer"] if m["name"] == name)


def test_entries():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert cells["train-2d-highres"]["config"] == "a100_2d_highres"
    assert cells["train-2d-kstep"]["traffic"] == "train_kstep"
    assert all(cells[c]["chips"] == 1 for c in ("train-2d-highres", "train-2d-kstep"))
    step = next(m for m in BENCH["end_to_end"] if m["name"] == "train_step_ms")
    assert step["workloads"][-2:] == ["train-2d-highres", "train-2d-kstep"]
    names = [m["name"] for m in BENCH["per_layer"]]
    assert names[-2:] == NEW_METRICS
    for m in BENCH["per_layer"]:
        if m["name"].endswith(".train") and m["name"] not in NEW_METRICS:
            assert "train-2d-highres" in m["workloads"], m["name"]
            assert ("train-2d-kstep" in m["workloads"]) == (
                m["name"] in ("device_idle.train", "mfu.train")), m["name"]
    assert _metric("gaussians_live.train")["workloads"] == [
        "train-2d", "train-3d", "train-2d-highres"]
    assert _metric("live_memory_gb.train")["workloads"] == [
        "train-2d", "train-3d", "train-2d-highres", "train-2d-kstep"]


def test_kstep_follows_every_step(tiny):
    cell = tiny("train-2d-kstep")
    s = cell.traffic.Session(cell, 2**31 + 77, "cpu")
    K = cell.workload["steps_per_call"]
    assert len(s.checked) == len(s.prog["losses"]) == cell.workload["checked_steps"] == K
    assert all(math.isfinite(x) for x in s.prog["losses"])
    # Adam's first gradient was read after step 1: the reference's loss
    # reaches the final U-Net and the head, not the first U-Nets' bodies.
    g = s.prog["grad_norms"]
    assert g["final_unet.encoder1.conv0.weight"] > 0 and g["head2.weight"] > 0
    assert g["unets.0.encoder1.conv0.weight"] is None
    assert s.flops_per_unit > 0
    e2e = s.window(0.2)
    assert s.attempted >= 1 and s.failed == 0
    assert e2e["train_step_ms"] > 0
    s.release()
    checks = s.check()
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks


def test_kstep_traced_run_has_no_failed_unit(tiny, monkeypatch):
    # The traced run waits for the card between its parts; the CPU has
    # nothing to wait for.
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    cell = tiny("train-2d-kstep")
    res = harness.run_cell(cell, 2**31 + 23, 0.3, True, "cpu", 0.0, log=lambda s: None)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 3 + 4
    assert "mfu.train" in res["metrics"]


def test_highres_traced_run_reports_the_selection(tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    cell = tiny("train-2d-highres")
    res = harness.run_cell(cell, 2**31 + 29, 0.3, True, "cpu", 0.0, log=lambda s: None)
    assert res["correct"], res["checks"]
    live = res["metrics"]["gaussians_live.train"]["value"]
    assert 16 <= live <= 256  # the tiny cut's min_n and max_n
    assert res["metrics"]["binning_dropped.train"]["value"] == 0.0
    assert "live_memory_gb.train" not in res["metrics"]  # no CUDA allocator


@pytest.mark.parametrize("name", NEW_METRICS)
def test_reader_is_silent_without_the_records(name, monkeypatch):
    from pose_splatter_torch.utils import stages

    reader = harness.Registry().module("metrics", name)
    # A program whose span units lack the records (the parent commit's).
    unit = dict(id=0, name="step", spans=[], host_syncs=1, sync_wait_ms=0.0,
                launches={}, binning_calls=1, binned_rows=10, dropped_rows=0)
    trace = types.SimpleNamespace(units=[unit], median=lambda k: unit[k])
    monkeypatch.setattr(stages, "last_trace", lambda: trace)
    assert reader.read(None) is None
    monkeypatch.delattr(stages, "last_trace")
    assert reader.read(None) is None


def test_memory_reader_in_gigabytes(monkeypatch):
    from pose_splatter_torch.utils import stages

    reader = harness.Registry().module("metrics", "live_memory_gb.train")
    units = [dict(max_allocated_bytes=b) for b in (2e9, 3e9, 4e9)]
    trace = types.SimpleNamespace(
        units=units, median=lambda k: sorted(u[k] for u in units)[1])
    monkeypatch.setattr(stages, "last_trace", lambda: trace)
    assert reader.read(None) == 3.0
