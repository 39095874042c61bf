"""The port's multi-rank entry points on the CPU, through the launcher:
``python -m pose_splatter_torch.graft_entry --dryrun 4`` (the counterpart
of ``__graft_entry__.py::dryrun_multichip``), the scaling script with
``--virtual 2`` at its smallest size (the rows of
``SCALING_r05_virtual.json``) and the high-res probe on 2 ranks at a
reduced grid and size (the full shape is the card's check)."""

import json
import re

import numpy as np
import pytest
import torch

from pose_splatter_torch.parallel.launch import launch
from pose_splatter_torch.scripts import dbg_highres_sharded as hr
from pose_splatter_torch.scripts import scaling

torch.set_num_threads(1)

SMALL = ["--width", "96", "--height", "64", "--grid", "32",
         "--crop", "0,32,0,32,8,24", "--min-n", "16", "--max-n", "256",
         "--carve-cap", "0", "--tile", "16,128", "--capacity", "256",
         "--device", "cpu"]


def test_dryrun_multichip_four_ranks():
    """Both of the JAX dry run's ``OK`` lines from rank 0: the DP step
    within 1e-4 relative of the unsharded step, the (data=2, tile=2) step
    through the kernel compositor within 1e-3 (each rank asserts both)."""
    res = launch(4, ["-m", "pose_splatter_torch.graft_entry", "--dryrun", "4",
                     "--device", "cpu"], timeout=300)
    out = res[0].output
    m1 = re.search(r"dryrun_multichip\(4\) OK: loss=([-\d.]+) \(unsharded "
                   r"([-\d.]+), tiled compositor, 4 tiles/frame\)", out)
    m2 = re.search(r"dryrun_multichip\(4\) OK: kernel compositor in the "
                   r"\(data=2, tile=2\) step, loss=([-\d.]+) \(unsharded "
                   r"([-\d.]+)\)", out)
    assert m1 and m2, out[-3000:]
    a, b = float(m1.group(1)), float(m1.group(2))
    assert abs(a - b) <= 1e-4 * max(1.0, abs(b))
    a, b = float(m2.group(1)), float(m2.group(2))
    assert abs(a - b) <= 1e-3 * max(1.0, abs(b))
    assert all("OK" not in r.output for r in res[1:])


def test_scaling_virtual_two(tmp_path):
    """``--virtual 2``: rows for 1 and 2 ranks with the JAX script's keys,
    frames = steps x ranks, efficiency against linear scaling of the first
    row, the SPMD baseline for 2, and the JSON file from rank 0."""
    out = tmp_path / "scaling.json"
    report = scaling.main(["--virtual", "2", "--size", "32", "--cameras", "2",
                           "--max-n", "64", "--out", str(out)])
    assert json.loads(out.read_text()) == report
    assert set(report) == {"rows", "backend", "devices_total",
                           "per_device_batch", "config"}
    assert (report["backend"], report["devices_total"]) == ("gloo", 2)
    assert report["config"] == "32x32 grid16 C2 mode=3d unets2 bf4"
    r1, r2 = report["rows"]
    assert set(r1) == {"devices", "steps_per_s", "frames_per_s", "efficiency",
                       "mpix_per_s_per_device"}
    assert set(r2) == set(r1) | {"spmd_efficiency"}
    assert (r1["devices"], r2["devices"], r1["efficiency"]) == (1, 2, 1.0)
    for r in (r1, r2):
        assert r["steps_per_s"] > 0
        assert r["frames_per_s"] == pytest.approx(r["steps_per_s"] * r["devices"],
                                                  abs=2e-4)
        assert r["mpix_per_s_per_device"] == pytest.approx(
            r["steps_per_s"] * 32 * 32 / 1e6, abs=1e-3)
    assert r2["efficiency"] == pytest.approx(
        r2["frames_per_s"] / (2 * r1["frames_per_s"]), abs=1e-3)
    assert r2["spmd_efficiency"] > 0


def test_highres_probe_two_ranks():
    """One step of the probe on a (data=1, tile=2) mesh at a reduced size:
    the JAX script's report keys, a finite loss equal to one rank's run of
    the same step within 2e-3 (the tile rows divide, so nothing pads)."""
    res = launch(2, ["-m", "pose_splatter_torch.scripts.dbg_highres_sharded",
                     "--devices", "2", *SMALL], timeout=300)
    out = res[0].output
    report = json.loads(re.search(r"^\{$.*^\}$", out, re.M | re.S).group())
    assert {"config", "voxels", "first_step_s", "steady_step_s", "loss",
            "loss_finite", "backend", "note"} <= set(report)
    assert report["loss_finite"] and report["backend"] == "gloo"
    assert report["voxels"] == 32 * 32 * 16
    assert "(data=1, tile=2)" in report["config"]
    one = hr.main(["--devices", "1", *SMALL])
    assert report["loss"] == pytest.approx(one["loss"], rel=2e-3)
    assert np.isfinite(one["first_step_s"])
