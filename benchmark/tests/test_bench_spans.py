"""The span readers on the CPU at a tiny size: a traced run of each cell
reports every metric that reads ``stages.last_trace()`` and lists the
cell, each finite; a program without span tracing (``last_trace``
absent) leaves them out without raising; and the metrics the benchmark
had before them keep their entries and readers."""

import hashlib
import json
import math

import pytest
import torch

from benchmark import harness

BENCH = harness.load_bench()
CELLS = [w["name"] for w in BENCH["workloads"]]
SPAN_METRICS = [
    "optimizer_span_ms.train", "carve_span_ms.train", "carve_span_ms.render",
    "unets_span_ms.render", "backward_span_ms.train", "binning_span_ms.train",
    "binning_span_ms.render", "host_syncs.train", "sync_wait_ms.train",
    "host_syncs.render", "sync_wait_ms.render", "binning_dropped.train",
    "binning_dropped.render"]
# The metrics before the span readers: name, source, cells, and the first
# 16 hex digits of the SHA-256 of the reader's file.
EARLIER = [
    ("optimizer_ms.train", "program_span", ('train-2d', 'train-3d'), "f51cfecf56a6c77a"),
    ("carve_ms.train", "program_span", ('train-2d', 'train-3d'), "a444853fe2b7cf0a"),
    ("carve_ms.render", "program_span", ('render-2d', 'render-3d'), "8087192206c92e05"),
    ("unets_ms.render", "program_span", ('render-2d', 'render-3d'), "e75caeb25757c727"),
    ("backward_ms.train", "program_span", ('train-2d', 'train-3d'), "e48ad6795ebc40b7"),
    ("binning_ms.train", "program_span", ('train-2d', 'train-3d'), "661f1f785e94107c"),
    ("binning_ms.render", "program_span", ('render-2d', 'render-3d'), "2fe592a8a26fa4c2"),
    ("composite_fwd_roofline.render", "device_trace", ('render-2d', 'render-3d'), "58226337be093edb"),
    ("composite_bwd_roofline.train", "device_trace", ('train-2d', 'train-3d'), "317d8fe7573bebaf"),
    ("device_idle.train", "device_trace", ('train-2d', 'train-3d'), "eed3199a555d3ee2"),
    ("device_idle.render", "device_trace", ('render-2d', 'render-3d'), "eed3199a555d3ee2"),
    ("mfu.train", "host_clock", ('train-2d', 'train-3d'), "fc5e30c2018ee6b5"),
    ("mfu.render", "host_clock", ('render-2d', 'render-3d'), "664a831279a6ea48"),
    ("device_ops_per_frame.render", "device_trace", ('render-2d', 'render-3d'), "f2748fa423a21e05"),
]


def _metric(name):
    return next(m for m in BENCH["per_layer"] if m["name"] == name)


@pytest.mark.parametrize("like", CELLS)
def test_traced_run_reports_the_span_metrics(tiny, like, monkeypatch):
    # The traced run waits for the card between its parts; the CPU has
    # nothing to wait for.
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    cell = tiny(like)
    res = harness.run_cell(cell, 2**31 + 21, 0.3, True, "cpu", 0.0,
                           log=lambda s: None)
    assert res["correct"], res["checks"]
    listed = [n for n in SPAN_METRICS if like in _metric(n)["workloads"]]
    assert len(listed) == (7 if like.startswith("train") else 6)
    for name in listed:
        value = res["metrics"][name]["value"]
        assert math.isfinite(value) and value >= 0, name
    kind = like.split("-")[0]
    assert res["metrics"][f"host_syncs.{kind}"]["value"] == 1.0
    assert res["metrics"][f"binning_dropped.{kind}"]["value"] == 0.0


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_is_silent_without_span_tracing(name, monkeypatch):
    from pose_splatter_torch.utils import stages

    reader = harness.Registry().module("metrics", name)
    monkeypatch.delattr(stages, "last_trace")
    assert reader.read(None) is None


def test_span_metrics_entries():
    for name in SPAN_METRICS:
        m = _metric(name)
        assert m["source"] in ("program_span", "program_counter")
        twin = name.replace("_span_ms", "_ms")
        if twin != name:
            t = _metric(twin)
            assert (m["layer"], m["moves"], m["workloads"]) == \
                (t["layer"], t["moves"], t["workloads"])
    names = [m["name"] for m in BENCH["per_layer"]]
    assert names[-len(SPAN_METRICS):] == SPAN_METRICS


@pytest.mark.parametrize("name,source,cells,digest", EARLIER)
def test_earlier_metrics_keep_their_readers_and_cells(name, source, cells, digest):
    m = _metric(name)
    assert (m["source"], tuple(m["workloads"])) == (source, cells)
    path = harness.HERE / "metrics" / f"{name}.py"
    assert hashlib.sha256(path.read_bytes()).hexdigest()[:16] == digest
    names = [x["name"] for x in BENCH["per_layer"]]
    assert names.index(name) == [e[0] for e in EARLIER].index(name)
