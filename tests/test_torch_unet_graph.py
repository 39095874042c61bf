"""The eval U-Net stack's CUDA graph (``PoseSplatterNet.process_volume``) on
the CPU: the rule that engages it, case by case; on the CPU it never
captures, counts nothing and returns the eager stack's output; and the
data pointers by which a replay finds a changed storage.

The graph itself runs on the card: ``tests/test_torch_cuda_unet_graph.py``.
"""

import pytest
import torch
import torch.nn as nn

from pose_splatter_torch.models import pose_splatter as ps
from pose_splatter_torch.models.pose_splatter import PoseSplatterNet
from pose_splatter_torch.utils import stages

torch.set_num_threads(1)

SIZE = (16, 16, 16)


def _net(ablation=False):
    torch.manual_seed(0)
    return PoseSplatterNet(input_size=SIZE, base_filters=4, ablation=ablation)


def _volume(seed):
    g = torch.Generator().manual_seed(seed)
    # The served layout: the carve's [4, n1, n2, n3] permuted, not copied.
    return torch.rand((4,) + SIZE, generator=g).permute(1, 2, 3, 0)[None]


# (device, grad mode, new_stats, ablation, capturing) -> engages
ENGAGES = {
    "served": (("cuda", False, None, False, False), True),
    "cpu": (("cpu", False, None, False, False), False),
    "grad": (("cuda", True, None, False, False), False),
    "batch_statistics": (("cuda", False, {}, False, False), False),
    "ablation": (("cuda", False, None, True, False), False),
    "capturing": (("cuda", False, None, False, True), False),
}


@pytest.mark.parametrize("case", sorted(ENGAGES))
def test_the_graph_engages_only_on_a_served_eval_stack(monkeypatch, case):
    """Each condition alone keeps the stack eager. The device is only a
    ``torch.device`` here: nothing is allocated on it, and the capture
    query is the stub's."""
    (device, grad, new_stats, ablation, capturing), want = ENGAGES[case]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    net = _net(ablation)
    with torch.set_grad_enabled(grad):
        got = net.unet_graph_engages(torch.device(device), new_stats)
    assert got is want


@pytest.mark.parametrize("mode", ["no_grad", "grad", "batch_statistics"])
def test_the_cpu_never_captures(mode):
    """More calls than the warm-up and the capture take, each equal to the
    eager stack; no capture, no replay, and a traced unit's
    ``unets_graph`` launches 0."""
    net = _net()
    calls = ps.UNET_GRAPH_WARMUP + 2
    launches = ps._UnetGraph.launches
    with torch.set_grad_enabled(mode == "grad"), stages.trace("cpu"):
        for i in range(calls):
            v = _volume(i)
            stats = {} if mode == "batch_statistics" else None
            with stages.Scope("frame"):
                got = net.process_volume(v, stats)
            want = net._unet_stack(v, stats)
            assert torch.equal(got, want)
            assert got.shape == (net.out_channels, v[0, ..., 0].numel())
    assert net.unet_graph_captures == net.unet_graph_replays == 0
    assert not net._unet_graphs
    assert ps._UnetGraph.launches == launches
    units = stages.last_trace().units
    assert len(units) == calls
    assert all(u["launches"]["unets_graph"] == 0 for u in units)


def _ptrs(net):
    return ps._data_ptrs(net.final_unet, [])


def test_in_place_updates_keep_the_data_pointers():
    """An Adam step, the train loop's ``copy_`` of running statistics and
    ``load_state_dict`` write in place: the graph keeps reading the same
    storage, so a replay needs no new capture."""
    net, twin = _net(), _net()
    ptrs = _ptrs(net)
    assert len(ptrs) == (len(list(net.final_unet.parameters()))
                         + len(list(net.final_unet.buffers())))
    opt = torch.optim.Adam(net.parameters(), lr=1e-2)
    for p in net.final_unet.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    with torch.no_grad():
        for b in net.final_unet.buffers():
            b.copy_(b * 0.9 + 0.1)
    net.load_state_dict(twin.state_dict())
    assert _ptrs(net) == ptrs


@pytest.mark.parametrize("change", ["to", "dtype", "parameter", "buffer",
                                    "module"])
def test_a_new_storage_changes_the_data_pointers(change):
    """A move to another device and back (``meta``, then ``to_empty``), a
    dtype's round trip, a re-assigned parameter or buffer, a replaced
    submodule: each moves some pointer, so the next replay captures again.
    The old storages are held, so the new ones cannot land at their
    addresses."""
    net = _net()
    ptrs = _ptrs(net)
    held = [t.detach() for t in net.final_unet.parameters()]
    held += list(net.final_unet.buffers())
    unet = net.final_unet
    if change == "to":
        net.to("meta").to_empty(device="cpu")
    elif change == "dtype":
        net.double().float()
    elif change == "parameter":
        unet.final_conv.weight = nn.Parameter(unet.final_conv.weight.detach() * 2)
    elif change == "buffer":
        unet.encoder1.bn0.running_var = unet.encoder1.bn0.running_var.clone()
    else:
        unet.encoder1 = type(unet.encoder1)(net.in_channels,
                                            unet.base_filters)
    assert len(held) == len(ptrs)
    assert _ptrs(net) != ptrs
