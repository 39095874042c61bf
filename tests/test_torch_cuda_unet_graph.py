"""The eval U-Net stack's CUDA graph (``PoseSplatterNet.process_volume``) on
the card, at the crop of the 2D and 3D templates (the benchmark's
``a6000_2d`` and ``rtx3060_3d``: 96x80x64, three U-Nets of width 8).

Replays equal the eager stack bit for bit over several volumes, and no
kept output is overwritten by a later replay; in-place weight updates (an
Adam step, ``load_state_dict``) reach the next replay with no new capture;
a ``.to()`` or a re-assigned parameter is captured again; inside an outer
capture, with grad on or with batch statistics nothing is replayed or
counted; a capture under ``torch.inference_mode`` replays outside it; a
served frame (``PoseSplatter.forward``) replays inside its ``unets`` span,
under ``stages.record()`` and ``stages.trace()``, and renders the eager
frame's image bit for bit.

Every test is marked ``cuda`` and skips where no CUDA device is present.
On a machine with an NVIDIA GPU:

    python -m pytest tests/test_torch_cuda_unet_graph.py -q -p no:cacheprovider --noconftest

(``--noconftest`` because the suite's conftest imports jax, which such a
machine need not have; this file imports only the port.)
"""

import json
from pathlib import Path

import pytest
import torch
import torch.nn as nn

from pose_splatter_torch.models import pose_splatter as ps
from pose_splatter_torch.models.pose_splatter import (
    UNET_GRAPH_WARMUP,
    PoseSplatterNet,
)
from pose_splatter_torch.models.unet3d import BatchNorm
from pose_splatter_torch.utils import stages
from pose_splatter_torch.utils.device import resolve_device
from test_torch_cuda_kernels import _small_run

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parent.parent
TEMPLATES = ["tpu_2d", "tpu_3d"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    return resolve_device("cuda")  # TF32 off, cuDNN autotuned, as served


def _crop(template):
    cfg = json.loads((ROOT / "configs/templates" / f"{template}.json").read_text())
    return tuple(hi - lo for lo, hi in cfg["volume_idx"])


def _net(dev, template, seed=0):
    """The template's net at its crop, Flax's initialisation from ``seed``
    and running statistics drawn away from 0 and 1, so eval reads them."""
    torch.manual_seed(seed)
    net = PoseSplatterNet(4, 8, base_filters=8, num_unets=3,
                          input_size=_crop(template)).to(dev)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 2.0)
    return net


def _volumes(dev, template, n, seed=1):
    """``n`` volumes in the served layout: the carve's [4, n1, n2, n3]
    permuted to NDHWC, not copied."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.rand((4,) + _crop(template), generator=g, device=dev)
            .permute(1, 2, 3, 0)[None] for _ in range(n)]


def _served(net, vols):
    with torch.no_grad():
        return [net.process_volume(v) for v in vols]


def _eager(net, vols):
    with torch.no_grad():
        return [net._unet_stack(v) for v in vols]


@pytest.mark.parametrize("template", TEMPLATES)
def test_replays_equal_the_eager_stack_and_keep_their_outputs(dev, template):
    """The warm-up calls, the capture and three replays of distinct volumes
    (so the static input is refreshed), each equal to the eager stack on
    its volume after every call has returned: a replay's output is its
    own, not the graph's static output."""
    net = _net(dev, template)
    vols = _volumes(dev, template, UNET_GRAPH_WARMUP + 3)
    launches = ps._UnetGraph.launches
    got = _served(net, vols)
    want = _eager(net, vols)
    assert net.unet_graph_captures == 1 and net.unet_graph_replays == 3
    assert ps._UnetGraph.launches - launches == 3
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.stride() == b.stride(), i
        assert torch.equal(a, b), (i, float((a - b).abs().max()))
    assert not torch.equal(got[-1], got[-2])
    assert not torch.equal(got[-2], got[-3])


@pytest.mark.parametrize("template", TEMPLATES)
def test_replays_follow_in_place_weight_updates(dev, template):
    """An Adam step and the train loop's ``copy_`` of the running
    statistics, then ``load_state_dict`` of another net's weights: each
    next replay equals the eager stack of the net that holds those weights,
    with no new capture."""
    net = _net(dev, template)
    vols = _volumes(dev, template, UNET_GRAPH_WARMUP + 1)
    v = vols[0]
    before = _served(net, vols)[0]
    opt = torch.optim.Adam(net.parameters(), lr=1e-2)
    for p in net.final_unet.parameters():
        p.grad = torch.randn_like(p)
    opt.step()
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.copy_(0.9 * m.running_mean + 0.01)
                m.running_var.copy_(0.9 * m.running_var + 0.1)
    stepped = _served(net, [v])[0]
    assert torch.equal(stepped, _eager(net, [v])[0])
    assert not torch.equal(stepped, before)
    twin = _net(dev, template, seed=1)
    net.load_state_dict(twin.state_dict())
    loaded = _served(net, [v])[0]
    assert torch.equal(loaded, _eager(twin, [v])[0])
    assert not torch.equal(loaded, stepped)
    assert net.unet_graph_captures == 1 and net.unet_graph_replays == 3


@pytest.mark.parametrize("change", ["to", "parameter"])
def test_a_new_storage_is_captured_again(dev, change):
    """A ``.to()`` (to the CPU and back) or a re-assigned parameter: the
    next call captures again and replays the new weights, equal to the
    eager stack. The old storages are held, so the new ones land
    elsewhere."""
    net = _net(dev, "tpu_2d")
    vols = _volumes(dev, "tpu_2d", UNET_GRAPH_WARMUP + 1)
    v = vols[0]
    before = _served(net, vols)[0]
    held = [t.detach() for t in net.final_unet.parameters()]
    if change == "to":
        net.cpu().to(dev)
    else:
        conv = net.final_unet.final_conv
        conv.weight = nn.Parameter(2 * conv.weight.detach())
    after = _served(net, [v])[0]
    del held
    assert net.unet_graph_captures == 2 and net.unet_graph_replays == 2
    assert torch.equal(after, _eager(net, [v])[0])
    assert torch.equal(after, before) == (change == "to")


def test_no_replay_inside_a_capture_with_grad_or_batch_statistics(dev):
    """With grad on, with batch statistics (``new_stats``) and inside an
    outer capture the stack runs eagerly: no graph, no count. The outer
    graph's replay equals the eager stack."""
    net = _net(dev, "tpu_2d")
    vols = _volumes(dev, "tpu_2d", 2)
    launches = ps._UnetGraph.launches
    with torch.enable_grad():
        for _ in range(UNET_GRAPH_WARMUP + 2):
            net.process_volume(vols[0])
    with torch.no_grad():
        for _ in range(UNET_GRAPH_WARMUP + 2):
            net.process_volume(vols[0], {})
        static = vols[0].clone()
        torch.cuda.synchronize()
        outer = torch.cuda.CUDAGraph()
        with torch.cuda.graph(outer):
            out = net.process_volume(static)
        static.copy_(vols[1])
        outer.replay()
    assert torch.equal(out, _eager(net, vols[1:])[0])
    assert net.unet_graph_captures == net.unet_graph_replays == 0
    assert not net._unet_graphs
    assert ps._UnetGraph.launches == launches


def test_a_capture_under_inference_mode_replays_outside_it(dev):
    """Warm-up and capture under ``torch.inference_mode``, then replays
    under ``torch.no_grad`` and back: the static buffers are ordinary
    tensors, so each replay may write them."""
    net = _net(dev, "tpu_2d")
    vols = _volumes(dev, "tpu_2d", UNET_GRAPH_WARMUP + 3)
    with torch.inference_mode():
        first = [net.process_volume(v) for v in vols[:UNET_GRAPH_WARMUP + 1]]
    second = _served(net, vols[UNET_GRAPH_WARMUP + 1:UNET_GRAPH_WARMUP + 2])
    with torch.inference_mode():
        third = [net.process_volume(vols[-1])]
    assert net.unet_graph_captures == 1 and net.unet_graph_replays == 3
    for a, b in zip(first + second + third, _eager(net, vols)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["2d", "3d"])
def test_a_served_frame_replays_inside_its_unets_span(dev, mode):
    """``PoseSplatter.forward``'s warm-up frames, the capturing frame
    traced, and a frame under ``stages.record()``: the capturing and the
    recorded frame each replay once inside their ``unets`` span, the
    recording closes its ``unets`` mark, and every frame renders the first
    (eager) frame's image bit for bit."""
    make, stack, _ = _small_run(dev, mode)
    model = make()
    args = tuple(stack[k][0] for k in ("mask", "img", "p_3d", "angle"))
    views = list(range(model.num_cameras))
    rgbs = [model(*args, views)[0] for _ in range(UNET_GRAPH_WARMUP)]
    with stages.trace(dev):
        rgbs.append(model(*args, views)[0])
    unit = stages.last_trace().units[-1]
    assert unit["launches"]["unets_graph"] == 1
    assert [s["name"] for s in unit["spans"]].count("unets") == 1
    with stages.record(dev) as rec:
        rgbs.append(model(*args, views)[0])
    assert len(rec.spans["unets"]) == 1 and rec.spans["unets"][0] > 0
    assert model.net.unet_graph_captures == 1
    assert model.net.unet_graph_replays == 2
    for rgb in rgbs[1:]:
        assert torch.equal(rgb, rgbs[0])
