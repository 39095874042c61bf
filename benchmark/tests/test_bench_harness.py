"""The harness on the CPU, at a tiny size, with no card: the files each
cell names, the traffic's determinism, the reference, the result line,
the contract's names and limits, the refusal to run without a card, a
cell added as new files only, and the faults that ``correct`` has to
catch."""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import compare, harness, program, scene
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train

BENCH = harness.load_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


# -- BENCHMARK.json and the files it names ------------------------------------

def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][:3] == ["python3", "-m", "benchmark.run"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    c = harness.load_cell(cell, BENCH)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert {k: c.workload[k] for k in ("config", "traffic", "chips", "why")} == \
        {k: entry[k] for k in ("config", "traffic", "chips", "why")}
    assert c.chips == 1
    assert hasattr(c.traffic, "Session")
    assert c.workload["config"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == cell)
    assert all(hasattr(r, "read") for r in c.readers.values())
    # Every cell reports setup_s, another end-to-end metric and a per-layer one.
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    assert set(c.workload["limits"]) and all(v > 0 for v in c.workload["limits"].values())


def test_names_units_and_fields():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (harness.REPO / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and 1 <= len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if "roofline" in m["name"]:
            assert m["unit"] == "%" and m["name"].split(".")[0].endswith("_roofline")
        moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
    assert {"mfu.train", "mfu.render"} <= {m["name"] for m in BENCH["per_layer"]}


def test_one_layer_name_per_layer():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    perf = (harness.REPO / "PERF.md").read_text()
    for layer in layers:
        assert layer in perf, layer


# -- traffic and inputs -------------------------------------------------------

def test_scene_matches_the_numpy_original():
    from pose_splatter_torch.utils.synthetic import ring_cameras, synthetic_frames

    Ks, Es = ring_cameras(6, 48, 40, focal=800.0 * 48 / 576, radius=0.6)
    tK, tE = scene.ring_cameras(6, 48, 40, "cpu")
    np.testing.assert_allclose(tK.numpy(), Ks, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tE.numpy(), Es, rtol=0, atol=1e-6)
    center, axes = (0.01, -0.02, 0.005), (0.055, 0.032, 0.028)
    ref = synthetic_frames(Ks, Es, 40, 48, center, axes, 3, seed=5)
    mask, img = scene.ellipsoid_frames(
        tK, tE, 40, 48, center, axes, torch.as_tensor(ref["p_3d"]),
        torch.as_tensor(ref["angle"]), list(range(6)))
    assert ref["mask"].sum() > 100
    assert np.mean(mask.numpy() != ref["mask"]) < 1e-3
    same = (mask.numpy() == ref["mask"])[..., None].repeat(3, -1)
    np.testing.assert_allclose(img.numpy()[same], ref["img"][same], atol=1e-5)


def test_inputs_and_weights_follow_the_seed(tiny):
    cell = tiny("train-2d")
    spec = ref_model.Spec(cell.config)
    a = program.Inputs(spec, 2**31 + 17, 3, "cpu")
    b = program.Inputs(spec, 2**31 + 17, 3, "cpu")
    c = program.Inputs(spec, 2**31 + 18, 3, "cpu")
    assert torch.equal(a.img, b.img) and torch.equal(a.p_3d, b.p_3d)
    assert not torch.equal(a.p_3d, c.p_3d)
    wa, wb = a.weights(), b.weights()
    assert all(torch.equal(wa[k], wb[k]) for k in wa)
    assert set(wa) == set(ref_model.param_shapes(spec))
    assert not torch.equal(wa["head1.weight"], c.weights()["head1.weight"])


def test_schedule_follows_the_seed(tiny):
    cell = tiny("train-2d")
    s1 = cell.traffic.Session(cell, 99, "cpu")
    s2 = cell.traffic.Session(cell, 99, "cpu")
    assert s1.checked == s2.checked
    assert [s1._draw() for _ in range(9)] == [s2._draw() for _ in range(9)]
    assert len({i for i, _ in s1.checked}) == len(s1.checked)  # rows differ


# -- the reference ------------------------------------------------------------

@pytest.mark.parametrize("like", ["train-2d", "train-3d"])
def test_reference_agrees_with_itself(tiny, like):
    cell = tiny(like)
    spec = ref_model.Spec(cell.config)
    inp = program.Inputs(spec, 3, 3, "cpu")
    steps = [dict(inp.frame(i), view=spec.observed[i], obs=i) for i in range(2)]
    w = inp.weights()
    a = ref_train.train_steps(w, spec, inp.cameras(), inp.grid, steps, spec.lr)
    b = ref_train.train_steps(w, spec, inp.cameras(), inp.grid, steps, spec.lr)
    assert a == b
    assert all(np.isfinite(a["losses"]))
    # The first two U-Nets pass their input through: no gradient, no move.
    assert a["grad_norms"]["unets.0.encoder1.conv0.weight"] is None
    assert a["change_norms"]["unets.1.final_conv.weight"] == 0.0
    assert a["change_norms"]["final_unet.encoder1.conv0.weight"] > 0
    r1 = ref_train.render_frames(w, spec, inp.cameras(), inp.grid, [inp.frame(0)], 5)
    r2 = ref_train.render_frames(w, spec, inp.cameras(), inp.grid, [inp.frame(0)], 5)
    assert torch.equal(r1[0], r2[0]) and r1[0].shape == (64, 64, 3)


# -- the result line and the run ---------------------------------------------

def test_result_line_keys():
    line = harness.result_line(True, 3, 0, {"setup_s": {"value": 1.0, "unit": "s"}},
                               {"platform": "gpu"}, {"x": {"value": 0, "limit": 1}})
    assert list(json.loads(line)) == ["correct", "attempted", "failed", "metrics",
                                      "device", "checks"]
    line = harness.result_line(False, 3, 1, {}, {}, {}, breakdown={"device_ops": []})
    assert list(json.loads(line)) == ["correct", "attempted", "failed", "metrics",
                                      "device", "breakdown", "checks"]


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "train-2d", "--seed", str(2**31 + 5),
                       "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


@pytest.mark.parametrize("like", ["train-2d", "render-2d", "render-3d", "train-3d"])
def test_tiny_run_is_correct(tiny, like):
    cell = tiny(like)
    res = harness.run_cell(cell, 2**31 + 99, 0.5, False, "cpu", 0.0, log=lambda s: None)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    e2e = {m["name"] for m in cell.end_to_end}
    assert set(res["metrics"]) == e2e


def test_a_cell_added_as_files_only(tmp_path):
    from conftest import tiny_cell

    cell, bench, registry = tiny_cell(tmp_path, "render-2d", name="throwaway",
                                      view=1)
    assert (tmp_path / "workloads" / "throwaway.json").is_file()
    assert harness.load_cell("throwaway", bench, registry).workload["view"] == 1
    res = harness.run_cell(cell, 7, 0.3, False, "cpu", 0.0, log=lambda s: None)
    assert res["correct"] and "render_frames_per_s" in res["metrics"]


# -- faults that ``correct`` has to catch ------------------------------------
# Batch 1 on one chip: no cell has half a batch to leave out or an exchange
# between chips to skip.

def test_unchanged_state_is_caught(tiny, monkeypatch):
    cell = tiny("train-2d")
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    res = harness.run_cell(cell, 11, 0.3, False, "cpu", 0.0, log=lambda s: None)
    assert not res["correct"]
    assert res["checks"]["step_gap"]["value"] >= 0.99


def test_altered_frame_is_caught(tiny, monkeypatch):
    cell = tiny("render-2d")
    from pose_splatter_torch.models.pose_splatter import PoseSplatter

    forward = PoseSplatter.forward

    def altered(self, *args, **kwargs):
        rgb, alpha = forward(self, *args, **kwargs)
        return rgb * 0.9, alpha

    monkeypatch.setattr(PoseSplatter, "forward", altered)
    res = harness.run_cell(cell, 13, 0.3, False, "cpu", 0.0, log=lambda s: None)
    assert not res["correct"]


def test_mismatch_and_gaps():
    a = np.zeros((4, 4, 3), np.uint8)
    b = a.copy()
    b[0, 0, 0] = 1
    assert compare.mismatch(a, b) == 1 / 48
    ref = dict(losses=[1.0, 2.0], grad_norms={"a": 1.0, "b": None, "c": 1e-9},
               change_norms={"a": 0.5, "b": 0.0, "c": 1e-4})
    assert compare.train_gaps(ref, ref) == dict(loss_gap=0.0, grad_gap=0.0, step_gap=0.0)
    moved_b = dict(ref, change_norms={"a": 0.5, "b": 0.1, "c": 0.3})
    # b is unmoved by the reference; c's gradient is under a thousandth of
    # the median, so its change is not compared.
    assert compare.train_gaps(moved_b, ref)["step_gap"] == pytest.approx(0.2)
