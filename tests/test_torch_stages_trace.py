"""The stage spans, counters and ranges of ``utils/stages.py`` around a
train step, an eval forward and a K-step call, on the CPU at a small
size: the spans' nesting and unit ids, an off path with no event, range
or clock read, the ``pose_splatter/*`` ranges in a ``torch.profiler``
trace, ``record()`` unchanged beside them, the host reads counted, the
kernels' launches a unit and the ring's bound.

The last test runs on the card (marker ``cuda``): ``host_syncs`` against
the synchronisations ``torch.cuda.set_sync_debug_mode("warn")`` reports
for a step and a frame of each preset, the launches a unit, and a unit's
child spans against its event-timed duration. It imports only the port:

    python -m pytest tests/test_torch_stages_trace.py -q -p no:cacheprovider --noconftest
"""

import json
import types
import warnings
from collections import deque
from pathlib import Path

import numpy as np
import pytest
import torch

from pose_splatter_torch.models.pose_splatter import PoseSplatter
from pose_splatter_torch.ops import carving
from pose_splatter_torch.ops import rasterize_kernels as RK
from pose_splatter_torch.train.loop import (
    create_train_state,
    make_train_multi_step,
    make_train_step,
)
from pose_splatter_torch.utils import stages
from pose_splatter_torch.utils.geometry import create_3d_grid
from pose_splatter_torch.utils.synthetic import ring_cameras, synthetic_frames

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
C, H, W = 5, 48, 64
KW = dict(ell=0.3, grid_size=32, min_n=32, max_n=256,
          volume_idx=[[8, 24]] * 3, num_unets=2, base_filters=4,
          gaussian_mode="2d", gaussian_config={"view_anchored": True},
          holdout_views=[1], volume_fill_color=0.38)
FRAME_CHILDREN = ["carve", "unets", "select_head", "binning", "kernel", "untile"]


@pytest.fixture(scope="module")
def setup():
    Ks, Es = ring_cameras(C, W, H, focal=150.0, radius=0.6)
    model = PoseSplatter(Ks, Es, W, H, render_mode="kernel", device="cpu", **KW)
    grid = create_3d_grid(KW["ell"], KW["grid_size"], KW["volume_idx"])
    frames = synthetic_frames(Ks, Es, H, W, grid.reshape(-1, 3).mean(0),
                              (0.05, 0.035, 0.03), n_frames=3, seed=0)
    obs = model.observed_views
    state = create_train_state(model, 1e-4)
    step = make_train_step(model, state.optimizer, 0.5, 0.1, batch_size=1)

    def batch(i):
        return dict(mask=torch.as_tensor(frames["mask"][i:i + 1, obs]),
                    img=torch.as_tensor(frames["img"][i:i + 1, obs]),
                    p_3d=torch.as_tensor(frames["p_3d"][i:i + 1]),
                    angle=torch.as_tensor(frames["angle"][i:i + 1]),
                    view_idx=torch.tensor([obs[0]]), obs_idx=torch.tensor([0]))

    def frame(i, view=0):
        return model(torch.as_tensor(frames["mask"][i, obs]),
                     torch.as_tensor(frames["img"][i, obs]),
                     torch.as_tensor(frames["p_3d"][i]),
                     torch.as_tensor(frames["angle"][i]), view)

    def train(i):
        nonlocal state
        state, m = step(state, batch(i))
        return m

    return types.SimpleNamespace(model=model, frames=frames, train=train,
                                 frame=frame, batch=batch, state=state)


def _by_name(unit):
    return {s["name"]: s for s in unit["spans"]}


def test_spans_nest_under_step_and_frame(setup):
    with stages.trace("cpu"):
        setup.train(0)
        setup.frame(1)
    t = stages.last_trace()
    step, frame = t.units[-2:]
    assert step["name"] == "step" and frame["name"] == "frame"
    assert step["id"] != frame["id"]
    names = [s["name"] for s in step["spans"]]
    assert names == (["step", "frame"] + FRAME_CHILDREN
                     + ["loss", "loss_bwd", "kernel_bwd", "backward",
                        "optimizer", "sync"])
    assert [s["name"] for s in frame["spans"]] == ["frame"] + FRAME_CHILDREN + ["sync"]
    for unit in (step, frame):
        spans = unit["spans"]
        assert spans[0]["parent"] == -1
        assert all(s["unit"] == unit["id"] for s in spans)
        for s in spans[1:]:
            p = spans[s["parent"]]
            assert p["start_ms"] <= s["start_ms"] <= s["end_ms"] <= p["end_ms"]
            assert s["device_ms"] >= 0 and s["lag_ms"] == 0.0
    by = _by_name(step)
    i_frame = step["spans"].index(by["frame"])
    for name in FRAME_CHILDREN:
        assert step["spans"][by[name]["parent"]]["name"] == "frame"
        assert by[name]["parent"] == i_frame
    for name in ("loss", "loss_bwd", "kernel_bwd", "backward", "optimizer", "sync"):
        assert by[name]["parent"] == 0
    # Adjacent stages share their boundary.
    for a, b in zip(FRAME_CHILDREN, FRAME_CHILDREN[1:]):
        assert by[a]["end_ms"] == by[b]["start_ms"]
    assert by["loss_bwd"]["end_ms"] == by["kernel_bwd"]["start_ms"]
    assert by["kernel_bwd"]["end_ms"] == by["backward"]["start_ms"]
    assert t.stage_ms("carve") == pytest.approx(
        np.median([_by_name(u)["carve"]["device_ms"] for u in t.units]))
    assert t.median("host_syncs") == 1


def test_off_path_records_nothing(setup, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the off path made an event, a range or a clock read")

    setup.train(0)  # warm
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    # (torch's own optimizer enters ranges of its own: refused for the
    # spans' module alone.)
    monkeypatch.setattr(stages, "_range", refuse)
    monkeypatch.setattr(stages, "time", types.SimpleNamespace(perf_counter=refuse))
    ring, syncs = len(stages._ring), stages.host_syncs
    last = stages._ring[-1] if stages._ring else None
    setup.train(1)
    setup.frame(2)
    assert stages._unit is None and len(stages._ring) == ring
    assert (stages._ring[-1] if stages._ring else None) is last
    assert stages.host_syncs == syncs + 2  # counted, tracing or not


def test_profiler_ranges_nest_in_the_frame(setup, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        setup.frame(0)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and str(e.get("name", "")).startswith("pose_splatter/")]
    by = {}
    for e in events:
        by.setdefault(e["name"][len("pose_splatter/"):], []).append(e)
    assert set(by) == {"frame", "sync"} | set(FRAME_CHILDREN)
    (frame,) = by["frame"]
    lo, hi = frame["ts"], frame["ts"] + frame["dur"]
    starts = []
    for name in FRAME_CHILDREN:
        (e,) = by[name]
        assert lo <= e["ts"] and e["ts"] + e["dur"] <= hi
        starts.append(e["ts"])
    assert starts == sorted(starts)
    # The profiled stretch is the record's latest.
    unit = stages.last_trace().units[-1]
    assert unit["name"] == "frame" and len(stages.last_trace().units) == 1


@pytest.mark.parametrize("traced", [False, True])
def test_record_keeps_keys_order_and_values(setup, traced):
    def recorded():
        with stages.record("cpu") as rec:
            out = setup.frame(0)
        return rec, out

    plain, _ = recorded()
    if traced:
        with stages.trace("cpu"):
            setup.frame(1)
            rec, out = recorded()
        unit = stages._ring[-1]
        assert unit.synced
        ids = [u["id"] for u in stages.last_trace().units]
        assert unit.id not in ids and len(ids) == 1
    else:
        rec, out = recorded()
    assert list(rec.spans) == FRAME_CHILDREN == list(plain.spans)
    assert all(len(v) == 1 for v in rec.spans.values())
    assert list(rec.values) == ["select_head", "binning"]
    b0, b1 = plain.values["binning"][0], rec.values["binning"][0]
    assert torch.equal(b0.counts, b1.counts) and int(b0.overflow) == int(b1.overflow)
    assert torch.equal(plain.values["select_head"][0]["valid"],
                       rec.values["select_head"][0]["valid"])
    assert not hasattr(rec, "ms")


def test_recorded_step_keeps_its_marks(setup):
    with stages.trace("cpu"), stages.record("cpu") as rec:
        setup.train(2)
    assert list(rec.spans) == (["data"] + FRAME_CHILDREN
                               + ["loss", "loss_bwd", "kernel_bwd", "backward",
                                  "optimizer"])
    assert list(rec.values) == ["select_head", "binning", "loss", "kernel_bwd",
                                "optimizer"]
    assert stages._ring[-1].synced


def test_host_syncs_once_a_step_and_once_a_frame(setup, monkeypatch):
    reads = []
    check = PoseSplatter.check_selection

    def counted(self):
        reads.append(stages.host_syncs)
        return check(self)

    monkeypatch.setattr(PoseSplatter, "check_selection", counted)
    with stages.trace("cpu"):
        s0 = stages.host_syncs
        setup.train(0)
        s1 = stages.host_syncs
        setup.frame(0)
        s2 = stages.host_syncs
    assert (s1 - s0, s2 - s1) == (1, 1) and len(reads) == 2
    step, frame = stages.last_trace().units
    assert step["host_syncs"] == frame["host_syncs"] == 1
    assert [s["name"] for s in step["spans"]].count("sync") == 1
    assert step["sync_wait_ms"] == _by_name(step)["sync"]["host_ms"] >= 0


def test_launches_and_binning_a_unit(setup, monkeypatch):
    """The CPU runs the kernels' plain versions, which count nothing;
    counted here as the card's wrappers count their launches."""
    fwd, bwd = RK.composite_instances_ref, RK.composite_instances_bwd_ref
    vis = carving.visibility_pair_ref

    def fwd_counted(*a, **k):
        RK.composite_instances.launches += 1
        return fwd(*a, **k)

    def bwd_counted(*a, **k):
        RK.composite_instances_bwd.launches += 1
        return bwd(*a, **k)

    def vis_counted(*a, **k):
        carving.ray_cast_visibility_pair.launches += 1
        return vis(*a, **k)

    monkeypatch.setattr(RK, "composite_instances_ref", fwd_counted)
    monkeypatch.setattr(RK, "composite_instances_bwd_ref", bwd_counted)
    monkeypatch.setattr(carving, "visibility_pair_ref", vis_counted)
    # The counters are the process's: put them back for the tests that
    # hold them at 0 on the CPU.
    for wrapper in (RK.composite_instances, RK.composite_instances_bwd,
                    carving.ray_cast_visibility_pair):
        monkeypatch.setattr(wrapper, "launches", wrapper.launches)
    with stages.trace("cpu"):
        setup.train(1)
        setup.frame(1)
    step, frame = stages.last_trace().units
    assert step["launches"] == dict(composite_fwd=1, composite_bwd=1,
                                    carve_visibility=1, conv3d_wgrad=0,
                                    unets_graph=0)
    assert frame["launches"] == dict(composite_fwd=1, composite_bwd=0,
                                     carve_visibility=1, conv3d_wgrad=0,
                                     unets_graph=0)
    for u in (step, frame):
        assert u["binning_calls"] == 1
        assert u["binned_rows"] > 0 and u["dropped_rows"] >= 0


def test_multi_step_is_one_unit(setup):
    model = setup.model
    obs = model.observed_views
    state = create_train_state(model, 1e-4)
    frames = {k: setup.frames[k][:, obs] if k in ("mask", "img") else setup.frames[k]
              for k in ("mask", "img", "p_3d", "angle")}
    ms = make_train_multi_step(model, state.optimizer, 0.5, 0.1, frames,
                               steps_per_call=2)
    with stages.trace("cpu"):
        ms(state, [0, 1], [obs[0], obs[1]], [0, 1])
    (unit,) = stages.last_trace().units
    names = [s["name"] for s in unit["spans"]]
    assert names[0] == "multi_step" and names.count("frame") == 2
    assert names.count("optimizer") == 2 and names[-1] == "sync"
    assert unit["host_syncs"] == 1


def test_ring_is_bounded(setup, monkeypatch):
    monkeypatch.setattr(stages, "_ring", deque(maxlen=3))
    with stages.trace("cpu"):
        for i in range(5):
            setup.frame(i % 3)
    assert len(stages._ring) == 3
    assert len(stages.last_trace().units) == 3
    with pytest.raises(RuntimeError, match="already active"):
        with stages.trace("cpu"), stages.trace("cpu"):
            pass


# -- on the card ---------------------------------------------------------------

def _preset(path, dev, anchored=False, **overrides):
    from pose_splatter_torch.config import Config
    from pose_splatter_torch.models.pose_splatter import init_means2d_center
    from pose_splatter_torch.models.unet3d import init_unet_primary_skip
    from pose_splatter_torch.train.trainer import build_model

    cfg = json.loads((ROOT / path).read_text())
    cfg.update(overrides)
    if anchored:
        cfg["gaussian_config"] = dict(cfg["gaussian_config"], view_anchored=True)
    config = Config(cfg)
    Wc, Hc = config.render_width, config.render_height
    Ks, Es = ring_cameras(6, Wc, Hc, focal=800.0 * Wc / 576, radius=0.6)
    model = build_model(config, device=dev, cameras=(Ks, Es))
    init_unet_primary_skip(model.net, in_channels=model.in_channels)
    if model.gaussian_mode == "2d":
        init_means2d_center(model.net, model.W, model.H,
                            anchored=model.view_anchored_2d)
    grid = create_3d_grid(config.ell, config.grid_size, config.volume_idx)
    frames = synthetic_frames(Ks, Es, Hc, Wc, grid.reshape(-1, 3).mean(0),
                              (0.0385, 0.0224, 0.0196), 2, seed=1)
    return config, model, frames


def _sync_warnings(fn):
    """Run ``fn`` under the sync debug mode; the synchronisations torch
    reported."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return [w for w in caught if "synchronizing CUDA operation" in str(w.message)]


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["2d", "3d"])
def test_host_syncs_match_torch_on_the_card(preset):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sync debug mode and events are the card's")
    dev = torch.device("cuda")
    if preset == "2d":
        config, model, frames = _preset(
            "configs/templates/tpu_2d.json", dev, anchored=True, min_n=1024,
            max_n=16000, num_unets=3, base_filters=8)
    else:
        config, model, frames = _preset("configs/templates/tpu_3d.json", dev)
    obs = model.observed_views
    held = [v for v in range(6) if v not in obs][0]
    state = create_train_state(model, 1e-4)
    step = make_train_step(model, state.optimizer, config.img_lambda,
                           config.ssim_lambda, batch_size=1)
    f = {k: torch.as_tensor(v, device=dev) for k, v in frames.items()}
    batch = dict(mask=f["mask"][:1, obs], img=f["img"][:1, obs], p_3d=f["p_3d"][:1],
                 angle=f["angle"][:1], view_idx=torch.tensor([obs[0]], device=dev),
                 obs_idx=torch.tensor([0], device=dev))

    def train():
        step(state, batch)

    args = (f["mask"][1, obs], f["img"][1, obs], f["p_3d"][1], f["angle"][1])

    def frame():  # the serving loop's call: the view as a host int
        model(*args, held)

    # Build and warm: the frame's U-Net graph is captured at its third call.
    for fn in (train, frame, train, frame, frame):
        fn()
    torch.cuda.synchronize()
    reported = {}
    for fn in (train, frame):
        s0 = stages.host_syncs
        reported[fn] = len(_sync_warnings(fn))
        assert stages.host_syncs - s0 == reported[fn] >= 1, fn.__name__
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with stages.trace(dev):
        for fn in (train, frame):
            start.record()
            fn()
            stop.record()
            torch.cuda.synchronize()
            timed = start.elapsed_time(stop)
            unit = stages.last_trace().units[-1]
            children = [s for s in unit["spans"] if s["parent"] == 0]
            total = sum(s["device_ms"] for s in children)
            assert abs(total - timed) <= 0.1 * timed, (fn.__name__, total, timed)
            assert unit["host_syncs"] == reported[fn]
    step_u, frame_u = stages.last_trace().units
    assert step_u["launches"] == dict(composite_fwd=1, composite_bwd=1,
                                      carve_visibility=1, conv3d_wgrad=12,
                                      unets_graph=0)
    assert frame_u["launches"] == dict(composite_fwd=1, composite_bwd=0,
                                       carve_visibility=1, conv3d_wgrad=0,
                                       unets_graph=1)
    if preset == "3d":
        return
    # A K-step call: its eager warm-up steps have spans; the captured step
    # has none, and a call of replays is one "multi_step" span and its read.
    ms = make_train_multi_step(model, state.optimizer, config.img_lambda,
                               config.ssim_lambda,
                               {k: f[k][:, obs] if k in ("mask", "img") else f[k]
                                for k in ("mask", "img", "p_3d", "angle")},
                               steps_per_call=4)
    with stages.trace(dev):
        for _ in range(2):
            ms(state, [0, 1, 0, 1], [obs[0]] * 4, [0] * 4)
    warm, replayed = stages.last_trace().units
    names = [s["name"] for s in warm["spans"]]
    assert names[0] == "multi_step" and names.count("frame") == 3
    assert [s["name"] for s in replayed["spans"]] == ["multi_step", "sync", "sync"]
    assert replayed["host_syncs"] == 2  # the index copy and the flag's read
