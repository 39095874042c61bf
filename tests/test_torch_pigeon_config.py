"""The ``pigeon_4`` preset as the benchmark runs it, on the CPU at a small
cut: its configuration file against the published preset, the program's
adaptive-camera hook against the plain reference's
(``benchmark/reference/adaptive.py``), the adaptive carve, an eval render
and 3 train steps of the cell's own traffic (``train_adaptive``) against
that reference on seeded random weights, the ``adaptive`` record and span
of ``utils/stages.py``, and the two cells the preset's PR added resolving
through the harness.

The cut is the one ``test_torch_cuda_entry_points.py`` uses for pigeon_4:
a 192x96 render and a 16^3 grid over the whole cube, with ``min_n`` 32,
``max_n`` 128 and two U-Nets of width 4; the traffic scales the scene's
focal length with the render's height (so the bird spans the same share
of it).
"""

import ast
import copy
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness, program  # noqa: E402
from benchmark.reference import adaptive as ref  # noqa: E402
from benchmark.reference.model import (  # noqa: E402
    Cameras,
    Spec,
    gaussians,
    pose_3d,
    process_volume,
)
from benchmark.traffic import train_adaptive  # noqa: E402
from pose_splatter_torch.ops.carving import carve_volume  # noqa: E402
from pose_splatter_torch.utils import stages  # noqa: E402

torch.set_num_threads(1)

SOURCE = json.loads((ROOT / "configs/baseline/pigeon_4.json").read_text())
BENCH_CFG = json.loads((ROOT / "benchmark/configs/pigeon_4.json").read_text())
BENCH = harness.load_bench()
ADDED = {"name", "source", "cameras", "min_n", "max_n", "num_unets",
         "base_filters", "scene", "assumed"}
# The binning's caps, the one group of the source the configuration sets.
CAPS = {"tile_expand", "instance_cap"}
SMALL = dict(image_width=384, image_height=192, grid_size=16,
             volume_idx=[[0, 16]] * 3, min_n=32, max_n=128, num_unets=2,
             base_filters=4)
SEED = 3_000_000_019  # above 2**31, as the benchmark's seeds are


def small_config():
    cfg = copy.deepcopy(BENCH_CFG)
    cfg.update(SMALL)
    return cfg


def small_cell(tmp_path):
    """``train-pigeon4-adaptive`` at the small cut, as new files beside the
    benchmark's own (the harness's registry)."""
    bench = copy.deepcopy(BENCH)
    for kind in ("configs", "workloads"):
        (tmp_path / kind).mkdir()
    (tmp_path / "configs" / "pigeon_4_small.json").write_text(json.dumps(small_config()))
    wl = json.loads((ROOT / "benchmark/workloads/train-pigeon4-adaptive.json").read_text())
    wl.update(config="pigeon_4_small", frames=4)
    (tmp_path / "workloads" / "pigeon-small.json").write_text(json.dumps(wl))
    entry = next(w for w in bench["workloads"] if w["name"] == "train-pigeon4-adaptive")
    bench["workloads"].append(dict(entry, name="pigeon-small", config="pigeon_4_small"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "train-pigeon4-adaptive" in m.get("workloads", ()):
            m["workloads"].append("pigeon-small")
    return harness.load_cell("pigeon-small", bench,
                             harness.Registry([tmp_path, harness.HERE]))


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """The cell's traffic at the small cut on the CPU: set-up (the hook's
    outputs staged, the 3 checked steps), two window steps, then the
    program's state released for the reference."""
    cell = small_cell(tmp_path_factory.mktemp("pigeon"))
    s = cell.traffic.Session(cell, SEED, "cpu")
    s.unit()
    s.unit()
    s.release()
    return s


# -- the configuration ---------------------------------------------------------

def test_benchmark_config_keeps_every_key_of_the_preset():
    """Every key of ``configs/baseline/pigeon_4.json`` as it is, but for the
    groups ``reduced`` names, which only add the binning's caps; beside
    them only the listed additions."""
    entry = next(c for c in BENCH["configs"] if c["name"] == "pigeon_4")
    assert entry["file"] == "benchmark/configs/pigeon_4.json"
    assert set(entry["reduced"]) <= {"gaussian_config"}
    for key, value in SOURCE.items():
        assert key in BENCH_CFG, key
        if key in entry["reduced"]:
            assert value == {} and set(BENCH_CFG[key]) <= CAPS, key
        else:
            assert BENCH_CFG[key] == value, key
    assert set(BENCH_CFG) - set(SOURCE) == ADDED
    assert BENCH_CFG["cameras"] == len(SOURCE["video_fns"]) == 4
    assert (BENCH_CFG["min_n"], BENCH_CFG["max_n"], BENCH_CFG["num_unets"],
            BENCH_CFG["base_filters"]) == (1024, 16000, 3, 8)
    spec = Spec(BENCH_CFG)
    assert (spec.W, spec.H, spec.crop, spec.observed) == (656, 320, (80,) * 3,
                                                          [0, 1, 2, 3])
    sc = BENCH_CFG["scene"]
    assert set(sc) == {"focal", "focal_height", "axes", "shift_sigma"}
    assert sc["focal_height"] == spec.H and len(sc["axes"]) == 3


def test_reference_imports_no_kernel_of_the_program_nor_jax():
    """``reference/adaptive.py`` and the reference modules it builds on
    import plain torch and the benchmark's reference only."""
    for name in ("adaptive", "model", "train"):
        tree = ast.parse((ROOT / "benchmark/reference" / f"{name}.py").read_text())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names]
        mods += [n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module]
        for m in mods:
            assert m.split(".")[0] in ("__future__", "math", "typing", "numpy",
                                       "torch", "benchmark"), (name, m)
            if m.startswith("benchmark"):
                assert m.startswith("benchmark.reference"), (name, m)


# -- the hook ------------------------------------------------------------------

def _scene_masks(cfg, n_frames, seed):
    spec = Spec(cfg)
    inp = train_adaptive.Inputs(spec, seed, n_frames, "cpu", cfg["scene"])
    return spec, inp


def test_hook_equals_the_reference():
    """The program's hook (``make_adaptive_fn``, float32 rig) and the
    reference's on seeded masks: the scene's silhouettes and random blobs.
    Both round ``temp_K`` to float32 from float64 arithmetic on the same
    float32 projection matrices, so they agree within 1e-9 px (the seeds
    within 1e-12 of the cube's 0.08)."""
    cfg = small_config()
    spec, inp = _scene_masks(cfg, 6, SEED)
    model = program.build(cfg, inp)
    hook = model.make_adaptive_fn()
    rng = np.random.default_rng(5)
    masks = [m for m in inp.mask]
    for _ in range(4):  # random blobs, each view's own
        blob = np.zeros((4, spec.H, spec.W), np.float32)
        for v in range(4):
            y, x = rng.integers(10, spec.H - 10), rng.integers(10, spec.W - 10)
            blob[v, y - rng.integers(1, 9):y + rng.integers(1, 9),
                 x - rng.integers(1, 9):x + rng.integers(1, 9)] = 1.0
        masks.append(torch.as_tensor(blob))
    shifts = []
    for m in masks:
        tK, seed = hook(m.numpy())
        rK, rseed = ref.hook(m, inp.Ks, inp.Es)
        assert tK.dtype == np.float32 and rK.dtype == torch.float32
        assert np.abs(tK - rK.numpy()).max() <= 1e-9
        assert np.abs(seed - rseed.numpy()).max() <= 1e-12
        shifts.append(np.abs(tK[:, :2, 2] - inp.Ks.numpy()[:, :2, 2]).max())
    assert min(shifts[:6]) > 0  # each frame's intrinsics leave the rig's


# -- the program against the reference at the small cut -------------------------

def test_adaptive_carve_matches_the_reference(session):
    """``carve_volume`` with ``K_mask`` and the grid at the seed against the
    reference's carve, on the staged frames and hooks: the same nearest
    pixels and visibility sort, so equal within float32 rounding of the
    colour weights (1e-6)."""
    spec, inp = session.spec, session.inputs
    cams = Cameras(inp.Ks, inp.Es, spec)
    for i, s in enumerate(session.ref_steps):
        tK, seed = session.hooks[i]
        got = carve_volume(s["mask"], s["img"], seed, s["angle"], inp.grid, tK,
                           cams.Ks_obs, cams.Es_obs,
                           volume_fill_color=spec.fill)
        want = ref.carve(spec, inp.grid, s["mask"], s["img"], seed, s["angle"],
                         tK, cams.Ks_obs, cams.Es_obs)
        assert got[0].sum() > 10  # the bird carves
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_eval_render_matches_the_reference():
    """An eval forward of the program (fresh model, the benchmark's
    weights) against the reference's, to each observed view once: the same
    float32 operations up to the order of the U-Nets' sums, so within
    1e-5 of a [0, 1] colour (the C.14 conic gates do not flip in this
    scene: the largest gap is ~1e-7)."""
    cfg = small_config()
    spec, inp = _scene_masks(cfg, 2, SEED + 1)
    model = program.build(cfg, inp)
    weights = inp.weights()
    cams = inp.cameras()
    hook = model.make_adaptive_fn()
    for f in range(2):
        tK, seed = hook(inp.mask[f].numpy())
        for view in (f, f + 2):  # each view once over the two frames
            rgb, _ = model(inp.mask[f], inp.img[f], inp.p_3d[f], inp.angle[f],
                           view, K_mask=torch.as_tensor(tK),
                           carve_center=torch.as_tensor(seed, dtype=torch.float32))
            want, alpha, dropped, _, _ = ref.forward(
                weights, spec, cams, inp.grid, inp.mask[f], inp.img[f],
                inp.p_3d[f], inp.angle[f], view, False,
                cfg["gaussian_config"].get("instance_cap"))
            assert int(dropped) == 0 and float(alpha.max()) > 0.1
            torch.testing.assert_close(rgb[0], want, atol=1e-5, rtol=0)


def test_render_and_its_gradients_match_the_reference():
    """The program's render of one frame's posed Gaussians (``model.render``
    through ``temp_K``, the compositors' plain versions) against the
    reference's ``render_3d``, with the gradients of a fixed random
    weighting of rgb and alpha. The image within 1e-6, the gradients of
    the means, log-scales, colours and opacities within 1e-5 relative
    (float32 sums in another order: they read ~1e-7). The quaternions'
    are not compared: the fresh head's Gaussians are all but isotropic, so
    a rotation hardly moves the image and its gradient is the cancellation
    of near-equal terms, round-off alone. Two float32 orderings of it
    differ by a third (this render against the reference 0.30, the
    program's ``global`` oracle against it 0.34; ROADMAP F.1)."""
    cfg = small_config()
    spec, inp = _scene_masks(cfg, 1, SEED)
    model = program.build(cfg, inp)
    weights, cams = inp.weights(), inp.cameras()
    tK, seed = ref.hook(inp.mask[0], cams.Ks_obs, cams.Es_obs)
    vol = ref.carve(spec, inp.grid, inp.mask[0], inp.img[0], seed.float(),
                    inp.angle[0], tK, cams.Ks_obs, cams.Es_obs)
    g = pose_3d(gaussians(weights, process_volume(weights, vol, spec, True),
                          inp.grid.reshape(-1, 3), spec),
                inp.angle[0], inp.p_3d[0])
    target = torch.rand((spec.H, spec.W, 3),
                        generator=torch.Generator().manual_seed(0))
    view = 1

    def grads(render):
        leaves = {k: v.detach().clone().requires_grad_(v.is_floating_point())
                  for k, v in g.items()}
        rgb, alpha = render(leaves)
        value = (rgb * target).sum() + (alpha * target[..., 0]).sum()
        names = [k for k in leaves if leaves[k].requires_grad]
        return rgb.detach(), dict(zip(names, torch.autograd.grad(
            value, [leaves[k] for k in names])))

    def program_render(leaves):
        Ks = model.Ks.index_copy(0, model.obs_index, tK)
        rgb, alpha, overflow = model.render(leaves, view, Ks)
        assert int(overflow) == 0
        return rgb[0], alpha[0]  # on the background, as the reference's

    def reference_render(leaves):
        rgb, alpha, dropped = ref.render_3d(
            leaves, cams.Es[view:view + 1], tK[view:view + 1], spec,
            cfg["gaussian_config"].get("instance_cap"))
        assert int(dropped) == 0
        return rgb, alpha

    rgb, got = grads(program_render)
    want_rgb, want = grads(reference_render)
    torch.testing.assert_close(rgb, want_rgb, atol=1e-6, rtol=0)
    for k in ("means", "log_scales", "colors", "logit_opacities"):
        assert float(want[k].norm()) > 0, k
        assert float((got[k] - want[k]).norm() / want[k].norm()) <= 1e-5, k


def test_train_steps_match_the_reference(session):
    """The traffic's 3 checked steps (the program's ``make_train_step``
    with each frame's staged ``K_mask`` and ``seed_3d``) against the
    reference's from the same weights, frames and draws, by the cell's own
    numbers (``compare.train_gaps`` and the first step's loss gap), and the
    hooks of both sides equal.
    Losses within 1e-6 relative (float32 sums in another order: they read
    ~3e-7). First-gradient norms and changes within 0.3 of the larger of
    the leaf's and the median leaf's: the quaternions' round-off
    (``test_render_and_its_gradients_match_the_reference``) reaches every
    leaf below the head through ``head2``, as in every 3D step (they read
    0.13 and 0.06 here; ``train-3d``'s tiny cell reads 0.03-0.09 and
    0.02-0.05 on the CPU; 0.3 is ``train-3d``'s ``step_gap`` limit on the
    card). The cell's own limits come from the card (PERF.md §2)."""
    refd = session.reference()
    gaps = session.gaps(session.prog, refd)
    assert len(session.prog["losses"]) == 3
    assert np.isfinite(session.prog["losses"]).all()
    assert gaps["first_loss_gap"] <= gaps["loss_gap"] <= 1e-6, gaps
    assert gaps["grad_gap"] <= 0.3, gaps
    assert gaps["step_gap"] <= 0.3, gaps
    for (k, s), (rk, rs) in zip(session.hooks, refd["hooks"]):
        assert torch.equal(k, rk) and torch.equal(s, rs.float())
    assert session.attempted == 2 and session.failed == 0
    # The cell's own check: the numbers its workload file names.
    checks = session.check()
    assert set(checks) == set(session.cell.workload["limits"])
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks


def test_float64_reference_finds_round_off(session):
    """``benchmark.calibrate_adaptive``'s float64 run of the reference on
    the same steps: the program and the float32 reference stand at gaps of
    one size from it (each first loss within 1e-6; the program's
    ``grad_gap`` and ``step_gap`` within 2x the float32 reference's, as
    round-off that any float32 step carries: 0.22 / 0.30 and 0.11 / 0.12
    here), the widest leaf of ``leaf_gaps`` is ``compare.train_gaps``'
    number, and the reference's modules are left as they were."""
    from benchmark import calibrate_adaptive as cal
    from benchmark.reference import model as ref_model
    from benchmark.reference import train as ref_train

    ref32 = session.reference()
    ref64 = cal.reference64(session)
    assert torch.get_default_dtype() == torch.float32
    assert ref_model.torch is torch and ref_train.torch is torch
    assert ref_model.select.__module__ == ref_model.__name__
    assert ref.carve.__module__ == ref.__name__
    prog, r32 = (session.gaps(side, ref64) for side in (session.prog, ref32))
    assert prog["first_loss_gap"] <= 1e-6 and r32["first_loss_gap"] <= 1e-6
    for k in ("grad_gap", "step_gap"):
        assert 0 < prog[k] <= 2 * r32[k], (prog, r32)
    gaps, leaves = session.gaps(session.prog, ref32), cal.leaf_gaps(session.prog, ref32)
    assert leaves["grad"][0][0] == pytest.approx(gaps["grad_gap"], rel=1e-2)
    assert leaves["step"][0][0] == pytest.approx(gaps["step_gap"], rel=1e-2)


# -- the record and the span -----------------------------------------------------

def test_adaptive_record_reads_a_known_shift():
    """A forward given ``K_mask`` keeps one record: the largest principal
    point shift over the views (1.5 px here) and the carve centre's
    distance from ``p_3d`` (3 voxels); a forward without it keeps none.
    The benchmark's reader gives the median shift over the units."""
    cfg = small_config()
    spec, inp = _scene_masks(cfg, 1, SEED)
    model = program.build(cfg, inp)
    K = model.Ks_obs.clone()
    K[2, 0, 2] += 1.5
    K[0, 1, 2] -= 0.75
    p_3d = inp.p_3d[0]
    center = p_3d + torch.tensor([3 * spec.voxel_size, 0.0, 0.0])
    with stages.trace("cpu"):
        model(inp.mask[0], inp.img[0], p_3d, inp.angle[0], 1, K_mask=K,
              carve_center=center)
        model(inp.mask[0], inp.img[0], p_3d, inp.angle[0], 1)
    a, b = stages.last_trace().units
    assert a["adaptive_calls"] == 1 and b["adaptive_calls"] == 0
    assert a["adaptive_shift_px"] == pytest.approx(1.5, abs=1e-4)
    assert a["seed_offset_vox"] == pytest.approx(3.0, abs=1e-4)
    assert b["adaptive_shift_px"] is None and b["seed_offset_vox"] is None
    reader = harness.Registry().module("metrics", "adaptive_shift_px.train")
    assert reader.read(None) == pytest.approx(1.5, abs=1e-4)


def test_evaluation_spans_the_hook():
    """``render_images_in_memory`` on an adaptive model: each frame's hook
    is a unit ``adaptive`` of its own, then the frame's forward with its
    record."""
    from pose_splatter_torch.train.evaluate import render_images_in_memory
    from pose_splatter_torch.utils.synthetic import FrameSet

    cfg = small_config()
    spec, inp = _scene_masks(cfg, 2, SEED)
    model = program.build(cfg, inp)
    frames = dict(mask=inp.mask.numpy(), img=inp.img.numpy(),
                  p_3d=inp.p_3d.numpy(), angle=inp.angle.numpy())
    with stages.trace("cpu"):
        rgba = render_images_in_memory(model, FrameSet(frames, [0, 1, 2, 3]))
    units = stages.last_trace().units
    assert [u["name"] for u in units] == ["adaptive", "frame"] * 2
    assert [u["adaptive_calls"] for u in units] == [0, 1] * 2
    assert all(u["adaptive_shift_px"] > 0 for u in units[1::2])
    assert rgba.shape == (2, 4, spec.H, spec.W, 4)


# -- the cells -------------------------------------------------------------------

@pytest.mark.parametrize("name", ["train-pigeon4-adaptive", "render-2d-highres"])
def test_new_cells_resolve_with_every_reader(name):
    cell = harness.load_cell(name, BENCH)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert cell.chips == entry["chips"] == 1
    assert {k: cell.workload[k] for k in ("config", "traffic", "why")} == \
        {k: entry[k] for k in ("config", "traffic", "why")}
    assert set(cell.readers) == {m["name"] for m in cell.per_layer}
    assert all(hasattr(r, "read") for r in cell.readers.values())
    e2e = {m["name"] for m in cell.end_to_end}
    if name == "train-pigeon4-adaptive":
        assert e2e == {"train_step_ms", "setup_s"}
        assert "adaptive_shift_px.train" in cell.readers
        assert cell.traffic.Session.kind == "train"
    else:
        assert e2e == {"render_frames_per_s", "render_frame_ms_p95", "setup_s"}
        assert cell.config["name"] == "a100_2d_highres"
        assert "binning_clamped.render" in cell.readers
        assert cell.traffic.Session.kind == "render"
    assert all(v > 0 for v in cell.workload["limits"].values())
