"""One adaptive train step of ``pigeon_4`` at its published widths on the
card: the benchmark's configuration (656x320, 4 cameras, the whole 80^3
cube, 3D Gaussians, the binning's caps) on its own scene, through
``make_train_step`` with the frame's ``K_mask`` and ``seed_3d`` from the
program's hook. One forward and one backward compositor launch, one
visibility launch, a weight-gradient launch for each conv the route takes
at the 80^3 cube, no binning row dropped, a finite loss, and the
``adaptive`` record read back.

Marked ``cuda``; skips without a CUDA device:

    python -m pytest tests/test_torch_cuda_pigeon.py -q -p no:cacheprovider --noconftest
"""

import json
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from pose_splatter_torch.utils import stages  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the compositor and carve kernels "
                    "have no CPU mode")
    return torch.device("cuda")


def test_adaptive_train_step_at_published_widths(dev):
    from benchmark import program
    from benchmark.reference.model import Spec
    from benchmark.traffic.train_adaptive import Inputs
    from pose_splatter_torch.scripts.dbg_conv_wgrad_micro import unet_convs
    from pose_splatter_torch.train.loop import create_train_state, make_train_step

    cfg = json.loads((ROOT / "benchmark/configs/pigeon_4.json").read_text())
    spec = Spec(cfg)
    inp = Inputs(spec, 7, 1, dev, cfg["scene"])
    model = program.build(cfg, inp)
    state = create_train_state(model, spec.lr)
    step = make_train_step(model, state.optimizer, spec.img_lambda,
                           spec.ssim_lambda)
    temp_K, seed = model.make_adaptive_fn()(inp.mask[0].cpu().numpy())
    batch = dict(mask=inp.mask[:1], img=inp.img[:1], p_3d=inp.p_3d[:1],
                 angle=inp.angle[:1],
                 view_idx=torch.tensor([2], device=dev),
                 obs_idx=torch.tensor([2], device=dev),
                 K_mask=torch.as_tensor(temp_K, device=dev)[None],
                 seed_3d=torch.as_tensor(seed, dtype=torch.float32, device=dev)[None])
    with stages.trace(dev):
        state, metrics = step(state, batch)
    (unit,) = stages.last_trace().units
    crop = [hi - lo for lo, hi in cfg["volume_idx"]]
    routed = sum(r["routed"] for r in unet_convs(crop, cfg["base_filters"]))
    assert unit["launches"] == dict(composite_fwd=1, composite_bwd=1,
                                    carve_visibility=1, carve_colors=1,
                                    conv3d_wgrad=routed,
                                    unets_graph=0), unit["launches"]
    assert unit["binned_rows"] > 0 and unit["dropped_rows"] == 0
    assert 0 < unit["gaussians_live"] <= cfg["max_n"]
    assert unit["adaptive_calls"] == 1 and unit["adaptive_shift_px"] > 0
    assert math.isfinite(float(metrics["total"]))
    for name, p in model.net.named_parameters():
        assert p.grad is None or torch.isfinite(p.grad).all(), name
