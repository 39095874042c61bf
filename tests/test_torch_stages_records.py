"""The selection record and the memory counter of ``utils/stages.py``, on
the CPU at a small size: the record's two counts in both regimes of the
adaptive threshold, a traced train step's record against the selection it
made, the counter's largest reading across a unit's span boundaries, and
nothing counted, read or computed with tracing off.

The last test runs on the card (marker ``cuda``): the counter against the
CUDA caching allocator's own statistics around a traced step. It imports
only the port:

    python -m pytest tests/test_torch_stages_records.py -q -p no:cacheprovider --noconftest
"""

import itertools
import math

import pytest
import torch

from pose_splatter_torch.models.pose_splatter import PoseSplatter, select_gaussians
from pose_splatter_torch.train.loop import create_train_state, make_train_step
from pose_splatter_torch.utils import stages
from pose_splatter_torch.utils.geometry import create_3d_grid
from pose_splatter_torch.utils.synthetic import ring_cameras, synthetic_frames

torch.set_num_threads(1)

C, H, W = 5, 48, 64
KW = dict(ell=0.3, grid_size=32, min_n=32, max_n=256,
          volume_idx=[[8, 24]] * 3, num_unets=2, base_filters=4,
          gaussian_mode="2d", gaussian_config={"view_anchored": True},
          holdout_views=[1], volume_fill_color=0.38)
SELECT = dict(prob_threshold=0.25, mask_threshold=0.25, mask_threshold_delta=0.05)
_UNIT = stages.Scope("frame")


def _model_and_step(dev="cpu", **overrides):
    Ks, Es = ring_cameras(C, W, H, focal=150.0, radius=0.6)
    kw = dict(KW, **overrides)
    model = PoseSplatter(Ks, Es, W, H, render_mode="kernel", device=dev, **kw)
    grid = create_3d_grid(kw["ell"], kw["grid_size"], kw["volume_idx"])
    frames = synthetic_frames(Ks, Es, H, W, grid.reshape(-1, 3).mean(0),
                              (0.05, 0.035, 0.03), n_frames=2, seed=0)
    obs = model.observed_views
    state = create_train_state(model, 1e-4)
    step = make_train_step(model, state.optimizer, 0.5, 0.1, batch_size=1)
    batch = dict(mask=torch.as_tensor(frames["mask"][:1, obs], device=dev),
                 img=torch.as_tensor(frames["img"][:1, obs], device=dev),
                 p_3d=torch.as_tensor(frames["p_3d"][:1], device=dev),
                 angle=torch.as_tensor(frames["angle"][:1], device=dev),
                 view_idx=torch.tensor([obs[0]], device=dev),
                 obs_idx=torch.tensor([0], device=dev))
    return model, lambda: step(state, batch)


@pytest.fixture(scope="module")
def small():
    return _model_and_step()


def _occupancy(n4: int, n2: int, n: int = 2048) -> torch.Tensor:
    """A carve's occupancy channel as the U-Nets pass it through: 4 where
    both thresholds hold, 2 where one does, 0 elsewhere, shuffled."""
    v = torch.zeros(n)
    v[:n4] = 4.0
    v[n4:n4 + n2] = 2.0
    return v[torch.randperm(n, generator=torch.Generator().manual_seed(0))]


@pytest.mark.parametrize("max_n,above,live", [
    (1000, 800, 800),  # the window holds the 800 occupied voxels: all kept
    (200, 300, 200),   # 300 at 4 exceed max_n: starved, max_n kept
])
def test_selection_record_in_both_regimes(max_n, above, live):
    vol0 = _occupancy(300, 500)
    with stages.trace("cpu"), _UNIT:
        sel = select_gaussians(vol0, 100, max_n, **SELECT)
    (unit,) = stages.last_trace().units[-1:]
    assert unit["selection_calls"] == 1
    assert (unit["above_threshold"], unit["gaussians_live"]) == (above, live)
    assert int(sel.valid.sum()) == live
    if above > max_n:  # every selected voxel near pt: the opacity starves
        assert float(sel.probs.max()) < 0.3


def test_a_traced_step_records_its_selection(small, monkeypatch):
    model, step = small
    kept = []
    select = model._select

    def spy(vol_flat):
        sel = select(vol_flat)
        kept.append((vol_flat[0].detach().clone(), sel))
        return sel

    monkeypatch.setattr(model, "_select", spy)
    with stages.trace("cpu"):
        step()
    unit = stages.last_trace().units[-1]
    ((vol0, sel),) = kept
    assert unit["name"] == "step" and unit["selection_calls"] == 1
    assert unit["gaussians_live"] == int(sel.valid.sum()) > 0
    # The final threshold f32(mt + logit(pt)), from the selection's mt.
    lp = torch.tensor(math.log(SELECT["prob_threshold"]
                               / (1.0 - SELECT["prob_threshold"])))
    thr = sel.mask_threshold + lp
    assert torch.equal(sel.valid, vol0[sel.indices] > thr)
    assert unit["above_threshold"] == int((vol0 > thr).sum()) >= unit["gaussians_live"]
    assert unit["max_allocated_bytes"] is None  # no CUDA allocator here


def test_memory_counter_keeps_the_largest(small, monkeypatch):
    _, step = small
    readings = itertools.cycle([7, 11, 3, 29, 5])
    seen = []

    def allocated(device):
        seen.append(next(readings))
        return seen[-1]

    step()  # warm
    monkeypatch.setattr(stages, "_allocated", allocated)
    with stages.trace("cpu"):
        step()
    unit = stages.last_trace().units[-1]
    # One reading a boundary: fewer than two a span, since adjacent stages
    # share theirs.
    assert 5 <= len(seen) < 2 * len(unit["spans"])
    assert unit["max_allocated_bytes"] == max(seen) == 29


def test_records_cost_nothing_off(small, monkeypatch):
    _, step = small

    class Refuses:
        def __getattr__(self, name):
            raise AssertionError("the off path computed a record")

        def __gt__(self, other):
            raise AssertionError("the off path computed a record")

    def refuse(*a, **k):
        raise AssertionError("the off path read the allocator")

    step()  # warm
    monkeypatch.setattr(stages, "_allocated", refuse)
    stages.selected(Refuses(), Refuses(), Refuses())
    ring = len(stages._ring)
    step()
    assert stages._unit is None and len(stages._ring) == ring


# -- on the card ---------------------------------------------------------------

@pytest.mark.cuda
def test_memory_counter_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the counter reads the CUDA caching allocator")
    dev = torch.device("cuda")
    model, step = _model_and_step(dev)
    for _ in range(3):  # build and warm
        step()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with stages.trace(dev):
        step()
    peak = torch.cuda.max_memory_allocated(dev)
    unit = stages.last_trace().units[-1]
    weights = sum(p.numel() * p.element_size() for p in model.net.parameters())
    # Read at the boundaries, so at least what the step started with and
    # at most the allocator's peak, which the counter leaves in place.
    assert weights <= before <= unit["max_allocated_bytes"] <= peak
    assert torch.cuda.max_memory_allocated(dev) == peak
    assert unit["gaussians_live"] > 0 and unit["selection_calls"] == 1
    assert unit["above_threshold"] >= unit["gaussians_live"]
