"""PoseSplatter: feed-forward Gaussian splatting from multi-view silhouettes.

Counterpart of ``pose_splatter_tpu/models/pose_splatter.py``, in eval
and train mode:

    carve → residual 3D U-Nets → Gaussian selection → per-voxel MLP head →
    3D: pose transform of world-space Gaussians → projection, depth sort
        and conic compositing (``ops/rasterize.py::rasterize``);
    2D: (view-anchored) projection → ellipse compositing
        (``rasterize_2d``).

With ``adaptive_camera`` each frame brings its own intrinsics for the
observed views (``temp_K``) and a triangulated seed from a host hook
(:meth:`PoseSplatter.make_adaptive_fn`): the mask is carved through
``temp_K`` around the seed, and the render uses ``temp_K`` too; each such
forward keeps an ``adaptive`` record (``utils/stages.py``).
``carve_visibility_cap`` sizes the carve's compacted visibility pair;
``remat_unets`` recomputes each U-Net's activations in the backward
(``torch.utils.checkpoint``). An eval forward on the card replays its
U-Net stack as one CUDA graph (:meth:`PoseSplatterNet.process_volume`).
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from pose_splatter_torch.models.unet3d import NewStats, Unet3D, flax_init_
from pose_splatter_torch.ops.carving import carve_volume
from pose_splatter_torch.ops.rasterize import rasterize, rasterize_2d
from pose_splatter_torch.utils import stages
from pose_splatter_torch.utils.cameras import adjust_principal_points_to_seed
from pose_splatter_torch.utils.device import resolve_device
from pose_splatter_torch.utils.geometry import (
    create_3d_grid,
    project_points,
    rotate_quats_by_yaw,
    yaw_rotation,
)


class GaussianSelection(NamedTuple):
    indices: torch.Tensor  # [max_n] voxel indices (by descending occupancy)
    valid: torch.Tensor  # [max_n] bool
    probs: torch.Tensor  # [max_n] selection probabilities at the final mt
    mask_threshold: torch.Tensor  # [] final threshold
    table_miss: torch.Tensor  # [] bool: the device route left its table


# Threshold iterates tabled each way from mask_threshold (the device route
# of select_gaussians), and the down steps tabled after an up run.
TABLE_STEPS = 1 << 14
AFTER_UP_STEPS = 4

_TABLES: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}
# The root span of a forward outside a train step (``utils/stages.py``).
_FRAME = stages.Scope("frame")


def _f32_walk(start: np.ndarray, step: np.float32, n: int) -> np.ndarray:
    """[..., n + 1]: start, then n float32 additions of ``step``, each
    rounded as the JAX loops round ``m + delta`` (``np.add.accumulate``
    adds in order; a float32 dtype rounds every partial sum)."""
    steps = np.broadcast_to(step, start.shape + (n,))
    return np.add.accumulate(np.concatenate([start[..., None], steps], -1),
                             axis=-1, dtype=np.float32)


def threshold_table(mask_threshold: float, mask_threshold_delta: float,
                    prob_threshold: float, device) -> Tuple[torch.Tensor, ...]:
    """The float32 iterates of both threshold loops, on ``device``, built
    once per (threshold, delta, pt, device).

    up_t [S+1]: ``f32(u_k + lp)`` for the up loop's u_0 = mt,
    u_{k+1} = f32(u_k + delta); down_u, down_nt [S+1]: the down loop's
    iterates from mt and their thresholds negated (so ascending);
    after_u, after_t [S+1, A+1]: row k the down loop's iterates from u_k
    and their thresholds. In float32 f32(u_k - delta) need not be
    u_{k-1}, so a down run after k up steps follows its own row, as the
    JAX loops do. Every sequence is monotone (rounding is),
    so a loop's stopping point is a count of table entries.
    """
    key = (float(mask_threshold), float(mask_threshold_delta),
           float(prob_threshold), torch.device(device))
    tables = _TABLES.get(key)
    if tables is None:
        f32 = np.float32
        lp = f32(math.log(prob_threshold / (1.0 - prob_threshold)))
        delta = f32(mask_threshold_delta)
        mt = np.asarray(mask_threshold, f32)
        up_u = _f32_walk(mt, delta, TABLE_STEPS)
        down_u = _f32_walk(mt, -delta, TABLE_STEPS)
        after_u = _f32_walk(up_u, -delta, AFTER_UP_STEPS)
        tables = tuple(
            torch.as_tensor(x, device=device) for x in (
                up_u + lp, down_u, -(down_u + lp), after_u, after_u + lp))
        _TABLES[key] = tables
    return tables


def _decisive_values(bits, vals_sorted, min_n: int, max_n: int):
    """v_lo, v_hi [1]: the values the loops' counts turn on, on the device
    (``bits``: vol0's float32 bit patterns).

    ``count(t) = #{v > t}`` skips NaNs, and the total order puts positive
    NaNs first, so the min_n-th and (max_n+1)-th largest counted values sit
    that many places down. v_lo is NaN where no such value exists (the JAX
    down loop would not end); v_hi is -inf where none exists (the up loop
    does not run)."""
    N = vals_sorted.shape[0]
    n_top = (bits > 0x7F800000).sum()
    pos = n_top + torch.arange(2, device=bits.device) * (max_n - min_n + 1) \
        + (min_n - 1)
    v = vals_sorted[pos.clamp(max=N - 1)]
    inside = pos < N
    v_lo = torch.where(inside[:1], v[:1], math.nan)
    v_hi = torch.where(inside[1:] & ~torch.isnan(v[1:]), v[1:], -math.inf)
    return v_lo, v_hi


def _loops_on_device(v_lo, v_hi, tables):
    """The threshold loops' outcome from the table, on the device with no
    read-back: (final mt [], its threshold f32(mt + lp) [], the table-miss
    flag [])."""
    up_t, down_u, down_nt, after_u, after_t = tables
    S, A = down_u.shape[0] - 1, after_u.shape[1] - 1
    # Up: u_k steps while v_hi > t_k; it stops at the count of t_k < v_hi.
    k = torch.searchsorted(up_t, v_hi)
    kc = k.clamp(max=S)
    # Down: d_j steps while not v_lo > t(d_j); it stops at the count of
    # t(d_j) >= v_lo, i.e. of -t(d_j) <= -v_lo.
    j0 = torch.searchsorted(down_nt, -v_lo, right=True)
    j1 = (after_t[kc] >= v_lo[:, None]).sum(-1)
    j0c, j1c = j0.clamp(max=S), j1.clamp(max=A)
    first = k == 0
    mt = torch.where(first, down_u[j0c], after_u[kc, j1c])
    thr = torch.where(first, -down_nt[j0c], after_t[kc, j1c])
    miss = ((k > S) | (first & (j0 > S)) | (~first & (j1 > A))
            | torch.isnan(v_lo))
    return mt[0], thr[0], miss[0]


def _loops_on_host(v_lo, v_hi, lp, mt, delta):
    """The JAX loops, run on the host over the two decisive values."""
    if np.isnan(v_lo):
        raise ValueError("fewer than min_n counted (non-NaN) occupancy values")
    steps = 0
    while v_hi > np.float32(mt + lp):
        mt = np.float32(mt + delta)
        steps += 1
        if steps > 10_000_000:
            raise RuntimeError("mask threshold loop did not terminate")
    while not v_lo > np.float32(mt + lp):
        mt = np.float32(mt - delta)
        steps += 1
        if steps > 10_000_000:
            raise RuntimeError("mask threshold loop did not terminate")
    return mt


def select_gaussians(
    vol0: torch.Tensor,
    min_n: int,
    max_n: int,
    prob_threshold: float,
    mask_threshold: float,
    mask_threshold_delta: float,
    route: str = "device",
) -> GaussianSelection:
    """Adaptive threshold + top-``max_n`` selection (``pose_splatter.py:56-81``).

    The threshold ``mt`` steps up by ``delta`` while more than ``max_n``
    voxels exceed ``mt + logit(pt)``, then down while fewer than ``min_n``
    do, in float32 as the JAX loops do. Both counts are read off the sorted
    values (count(t) > max_n iff the (max_n+1)-th largest counted value
    exceeds t; :func:`_decisive_values`).

    ``route`` "device" (the model's) finds where the loops stop in
    :func:`threshold_table` with no read-back, so a CUDA graph can capture
    it. A value past the table (or a missing v_lo) sets ``table_miss``
    instead of being clamped; the model raises on it
    (``PoseSplatter.check_selection``). "host" runs the loops themselves on
    the host over the two values (one read-back): the reference the tests
    hold the table against. Both give the JAX loops' threshold bit for
    bit.

    Ties: ``jax.lax.top_k`` puts the lower index first among equal values,
    and 2D compositing follows the selection order, so the order is taken
    from a stable descending sort (``torch.topk`` gives no tie order). The
    sort runs on the float32 total order that ``top_k`` uses, where -0.0
    sorts below +0.0 and positive NaNs above everything.

    Inside a traced unit the call keeps its record (``stages.selected``):
    the values above the final threshold and the Gaussians kept; more of
    the first than ``max_n`` is the opacity-starvation regime.
    """
    N = vol0.shape[0]
    if not 1 <= min_n <= max_n <= N:
        raise ValueError(f"need 1 <= min_n <= max_n <= N, got {min_n}, "
                         f"{max_n}, {N}")
    bits = vol0.detach().contiguous().view(torch.int32)
    order = torch.sort(bits ^ ((bits >> 31) & 0x7FFFFFFF), descending=True,
                       stable=True).indices
    vals_sorted = vol0.index_select(0, order)
    v_lo, v_hi = _decisive_values(bits, vals_sorted.detach(), min_n, max_n)
    f32 = np.float32
    if route == "device":
        tables = threshold_table(mask_threshold, mask_threshold_delta,
                                 prob_threshold, vol0.device)
        mt_t, thr, miss = _loops_on_device(v_lo, v_hi, tables)
    elif route == "host":
        lo, hi = stages.blocking(torch.cat([v_lo, v_hi]).cpu).numpy()
        lp = f32(math.log(prob_threshold / (1.0 - prob_threshold)))
        mt = _loops_on_host(lo, hi, lp, f32(mask_threshold),
                            f32(mask_threshold_delta))
        mt_t, thr = stages.to_device(np.array([mt, f32(mt + lp)], f32),
                                     vol0.device).unbind()
        miss = torch.zeros((), dtype=torch.bool, device=vol0.device)
    else:
        raise ValueError(f"unknown selection route {route!r}")
    vals = vals_sorted[:max_n]
    valid = vals > thr
    stages.selected(vol0, thr, valid)
    return GaussianSelection(indices=order[:max_n], valid=valid,
                             probs=torch.sigmoid(vals - mt_t),
                             mask_threshold=mt_t, table_miss=miss)


def take_rows_unique(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along rows, for UNIQUE indices (``pose_splatter.py:84-107``).

    The JAX function gives the gather a scatter-SET adjoint. Here the
    gather's own backward is a scatter-ADD (``index_add_``); with unique
    indices no two rows meet, so it computes the same gradient, and on the
    card no two atomics hit one address, so it is deterministic. Only top-k
    indices, unique by construction, may come here."""
    return x.index_select(0, idx)


# Eager eval calls at a new input layout before its U-Net stack is
# captured: the first times cuDNN's candidate algorithms (``utils/device.py``),
# so nothing is timed inside the capture.
UNET_GRAPH_WARMUP = 2


class _UnetGraph:
    """One input layout's eval U-Net stack: its eager warm-up calls left,
    then the CUDA graph, its static input and output, and the data
    pointers of the final U-Net's parameters and buffers it reads. The
    class's ``launches`` counts the replays of every net, reported a unit
    as ``launches["unets_graph"]`` (``utils/stages.py``)."""

    __slots__ = ("warmup_left", "graph", "static_in", "static_out",
                 "weights")
    launches = 0

    def __init__(self):
        self.warmup_left = UNET_GRAPH_WARMUP
        self.graph = self.static_in = self.static_out = self.weights = None


stages.count_launches("unets_graph", _UnetGraph)


def _data_ptrs(module: nn.Module, out: list) -> list:
    """The data pointers of ``module``'s parameters and buffers, depth
    first, appended to ``out``: the module dicts walked directly, at a
    third of ``named_parameters``' host cost."""
    for t in module._parameters.values():
        out.append(None if t is None else t.data_ptr())
    for t in module._buffers.values():
        out.append(None if t is None else t.data_ptr())
    for m in module._modules.values():
        _data_ptrs(m, out)
    return out


class PoseSplatterNet(nn.Module):
    """Trainable parameters: U-Net stack, Gaussian MLP head, scale offset.
    Module names follow the Flax module so the weight bridge is a rename.

    ``remat`` runs each U-Net under ``torch.utils.checkpoint`` (Flax's
    ``nn.remat``, ``pose_splatter.py:108-168``): only its input is kept for
    the backward, which runs its forward again. The parameters and their
    names do not change, so one bridge and one checkpoint serve both.

    ``unet_graph_captures`` and ``unet_graph_replays`` count the eval U-Net
    stack's CUDA-graph captures and replays (:meth:`process_volume`)."""

    def __init__(self, in_channels: int = 4, out_channels: int = 8,
                 base_filters: int = 8, num_unets: int = 3,
                 input_size: Sequence[int] = (64, 64, 64),
                 num_gaussian_params: int = 14, ablation: bool = False,
                 remat: bool = False):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.ablation = ablation
        self.remat = remat
        if not ablation:
            self.unets = nn.ModuleList([
                Unet3D(in_channels, in_channels, base_filters,
                       input_size=input_size)
                for _ in range(num_unets - 1)])
            self.final_unet = Unet3D(in_channels, out_channels, base_filters,
                                     input_size=input_size)
        self.head1 = nn.Linear(out_channels, 128)
        self.head2 = nn.Linear(128, num_gaussian_params)
        flax_init_(self.head1)
        flax_init_(self.head2)
        self.scale = nn.Parameter(torch.full((1,), -5.5))
        self._unet_graphs: Dict[tuple, _UnetGraph] = {}
        self.unet_graph_captures = 0
        self.unet_graph_replays = 0

    def process_volume(self, volume: torch.Tensor,
                       new_stats: Optional[Dict[str, torch.Tensor]] = None
                       ) -> torch.Tensor:
        """volume [1, n1, n2, n3, in_ch] (NDHWC) → [out_ch, n1*n2*n3].

        Eval mode reads the running BN statistics. Given a ``new_stats``
        dict, it runs in train mode (batch statistics, Flax's
        ``mutable=["batch_stats"]``) and fills the dict with the updated
        running statistics under their buffer names; the buffers themselves
        are not written.

        Where :meth:`unet_graph_engages`, the U-Net stack runs as a CUDA
        graph of the eval body (:meth:`_unet_stack`), one for each input
        layout (shape, strides, dtype, device): its first
        ``UNET_GRAPH_WARMUP`` calls run eagerly on a side stream, the next
        captures it and every call from then on copies the volume into the
        graph's static input, replays and returns a clone of the static
        output, so no caller's result is overwritten by a later replay. The
        graph reads the parameters and buffers in place, so in-place
        updates (an optimizer step, ``load_state_dict``, the train loop's
        running statistics) reach the next replay; a changed storage (a
        ``.to()``, a re-assigned parameter) is found by the final U-Net's
        data pointers, checked each replay, and the graph is captured
        again. The same kernels run on the same inputs, so a replay equals
        the eager body bit for bit. A capture that fails raises."""
        if self.ablation:
            v = volume[0]
            pad = torch.zeros(v.shape[:-1] + (self.out_channels - self.in_channels,),
                              dtype=v.dtype, device=v.device)
            return torch.cat([v, pad], -1).reshape(-1, self.out_channels).T
        if self.unet_graph_engages(volume.device, new_stats):
            with torch.cuda.device(volume.device):
                return self._unet_graph(volume)
        return self._unet_stack(volume, new_stats)

    def unet_graph_engages(self, device: torch.device,
                           new_stats: Optional[Dict] = None) -> bool:
        """Whether :meth:`process_volume` of a volume on ``device`` runs
        its U-Net stack as a CUDA graph: a CUDA device, eval statistics
        (``new_stats`` None), grad mode off, a net with U-Nets (not
        ``ablation``) and a current stream that is not capturing already
        (captures do not nest: inside an outer capture the stack is part of
        that graph). Everywhere else the stack runs eagerly."""
        return (device.type == "cuda" and new_stats is None
                and not torch.is_grad_enabled() and not self.ablation
                and not torch.cuda.is_current_stream_capturing())

    def _unet_graph(self, volume: torch.Tensor) -> torch.Tensor:
        key = (volume.shape, volume.stride(), volume.dtype, volume.device)
        g = self._unet_graphs.get(key)
        if g is None:
            g = self._unet_graphs[key] = _UnetGraph()
        if g.graph is None and g.warmup_left > 0:
            g.warmup_left -= 1
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                out = self._unet_stack(volume)
            main.wait_stream(side)
            out.record_stream(main)
            return out
        if g.graph is None or g.weights != _data_ptrs(self.final_unet, []):
            self._capture_unets(g, volume)
        g.static_in.copy_(volume)
        g.graph.replay()
        self.unet_graph_replays += 1
        _UnetGraph.launches += 1
        return g.static_out.clone()

    def _capture_unets(self, g: _UnetGraph, volume: torch.Tensor):
        """Capture the eval U-Net stack over a static input of ``volume``'s
        layout into ``g``, dropping any graph ``g`` held. The static
        buffers are ordinary tensors even under ``torch.inference_mode``,
        so replays outside it may write them."""
        g.graph = g.static_in = g.static_out = None
        with torch.inference_mode(False), torch.no_grad():
            # The volume's own strides: the served volume is a permuted
            # view whose NCDHW permute is contiguous, and a contiguous
            # static input would send the convs to other cuDNN kernels.
            g.static_in = torch.empty_strided(
                volume.shape, volume.stride(), dtype=volume.dtype,
                device=volume.device)
            graph = torch.cuda.CUDAGraph()
            # Only this thread's calls are held to the capture's rules: a
            # server's other threads may use the card meanwhile.
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                g.static_out = self._unet_stack(g.static_in)
        g.graph = graph
        g.weights = _data_ptrs(self.final_unet, [])
        self.unet_graph_captures += 1

    def _unet_stack(self, volume: torch.Tensor,
                    new_stats: Optional[Dict[str, torch.Tensor]] = None
                    ) -> torch.Tensor:
        """The U-Net stack run eagerly: :meth:`process_volume` without the
        ablation and the graph."""
        collect: Optional[NewStats] = None if new_stats is None else {}
        v = volume.permute(0, 4, 1, 2, 3)  # NCDHW
        for unet in self.unets:
            v = v + self._unet(unet, v, collect)
        v = self._unet(self.final_unet, v, collect)
        if collect:
            for name, mod in self.named_modules():
                if mod in collect:
                    mean, var = collect[mod]
                    new_stats[f"{name}.running_mean"] = mean
                    new_stats[f"{name}.running_var"] = var
        return v[0].reshape(self.out_channels, -1)

    def _unet(self, unet: Unet3D, v: torch.Tensor,
              collect: Optional[NewStats]) -> torch.Tensor:
        """One U-Net, under ``checkpoint`` when ``remat`` and a graph is
        being built. The backward's second forward normalises with the same
        batch statistics but writes its running statistics into a dict that
        is dropped: they are taken once, from the first forward. Nothing
        here draws random numbers, so no RNG state is saved (which a CUDA
        graph capture would refuse)."""
        if not (self.remat and torch.is_grad_enabled()):
            return unet(v, collect)
        first = [True]

        def run(x):
            stats = collect if first[0] or collect is None else {}
            first[0] = False
            return unet(x, stats)

        return checkpoint(run, v, use_reentrant=False,
                          preserve_rng_state=False)

    def gaussian_head(self, feats: torch.Tensor) -> torch.Tensor:
        """feats [n, out_ch] → [n, P]."""
        return self.head2(F.relu(self.head1(feats)))


@torch.no_grad()
def init_means2d_center(net: PoseSplatterNet, W: int, H: int,
                        sigma_px: float = 2.0, anchored: bool = False) -> None:
    """2D-mode init aid, in place (``pose_splatter.py:180-203``): bias the
    head so means2d start at the image center (not in anchored mode, where
    means are deltas from the voxel projection) and set the shared
    log-scale to ``log(sigma_px)``."""
    if not anchored:
        net.head2.bias[0] = W / 2.0
        net.head2.bias[1] = H / 2.0
    net.scale.fill_(math.log(sigma_px))


class PoseSplatter(nn.Module):
    """Cameras, voxel grid and the net, with the 3D and 2D forwards.

    Built in eval mode on ``device`` (default ``"cuda"``; raises without a
    CUDA device). Weights are initialized from ``seed`` without touching
    the global RNG; load trained or bridged weights into ``self.net``.
    """

    def __init__(
        self,
        intrinsics: np.ndarray,
        extrinsics: np.ndarray,
        W: int,
        H: int,
        in_channels: int = 4,
        out_channels: int = 8,
        base_filters: int = 8,
        ell: float = 0.18,
        grid_size: int = 64,
        min_n: int = 1024,
        max_n: int = 16000,
        num_unets: int = 3,
        color_clip: Tuple[float, float] = (0.0, 0.99),
        prob_threshold: float = 0.25,
        mask_threshold: float = 0.25,
        mask_threshold_delta: float = 0.05,
        volume_idx: Optional[Sequence[Sequence[int]]] = None,
        ablation: bool = False,
        volume_fill_color: float = 0.45,
        holdout_views: Sequence[int] = (),
        adaptive_camera: bool = False,
        gaussian_mode: str = "2d",
        gaussian_config: Optional[Dict[str, Any]] = None,
        background_color: Sequence[float] = (1.0, 1.0, 1.0),
        render_mode: str = "kernel",
        tile_shape: Optional[Tuple[int, int]] = None,
        tile_capacity: Optional[int] = None,
        carve_visibility_cap: Optional[int] = None,
        remat_unets: bool = False,
        device: Union[str, torch.device] = "cuda",
        seed: int = 0,
    ):
        super().__init__()
        if volume_idx is None:
            raise ValueError("volume_idx is required")
        if gaussian_mode not in ("2d", "3d"):
            raise ValueError(f"unknown gaussian_mode {gaussian_mode!r}")
        dev = resolve_device(device)
        self.W, self.H = W, H
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.min_n = min_n
        self.max_n = max_n
        self.color_clip = color_clip
        self.prob_threshold = prob_threshold
        self.mask_threshold = mask_threshold
        self.mask_threshold_delta = mask_threshold_delta
        self.volume_fill_color = float(volume_fill_color)
        self.holdout_views = list(holdout_views)
        self.adaptive_camera = adaptive_camera
        self.gaussian_mode = gaussian_mode
        self.gaussian_config = dict(gaussian_config or {})
        self.render_mode = render_mode
        self.tile_shape = tile_shape
        self.tile_capacity = tile_capacity
        # Static cap of the carve's visibility compaction; None = exact.
        self.carve_visibility_cap = carve_visibility_cap

        C = len(intrinsics)
        self.num_cameras = C
        self.observed_views = [i for i in range(C) if i not in self.holdout_views]
        obs = np.asarray(self.observed_views)
        Ks = torch.as_tensor(np.asarray(intrinsics, np.float32))
        Es = torch.as_tensor(np.asarray(extrinsics, np.float32))
        self.register_buffer("Ks", Ks, persistent=False)
        self.register_buffer("viewmats", Es, persistent=False)
        self.register_buffer("Ks_obs", Ks[obs], persistent=False)
        self.register_buffer("viewmats_obs", Es[obs], persistent=False)
        self.register_buffer("obs_index", torch.as_tensor(obs, dtype=torch.long),
                             persistent=False)
        self.register_buffer("background_color", torch.tensor(
            background_color, dtype=torch.float32), persistent=False)
        # Set when a device-route selection left its threshold table;
        # read and cleared by check_selection.
        self.register_buffer("selection_miss", torch.zeros(
            (), dtype=torch.bool), persistent=False)
        grid = torch.as_tensor(create_3d_grid(ell, grid_size, volume_idx=volume_idx))
        self.register_buffer("grid", grid, persistent=False)
        self.input_size = tuple(int(i2 - i1) for (i1, i2) in volume_idx)
        self.voxel_size = ell / grid_size
        self.num_gaussian_params = 14 if gaussian_mode == "3d" else 9
        self.sigma_cutoff = float(self.gaussian_config.get("sigma_cutoff", 3.0))
        # Max tiles one Gaussian may span in the binning (overflow counted);
        # the model's default is 16 (pose_splatter.py:287-295).
        te = self.gaussian_config.get("tile_expand")
        self.tile_expand = int(te) if te is not None else 16
        # Max instance rows a camera in the 3D kernel-mode binning
        # (overflow counted); None is the JAX package's 4·N + T·G.
        cap = self.gaussian_config.get("instance_cap")
        self.instance_cap = int(cap) if cap is not None else None
        # Anchor each 2D Gaussian at the projection of its pose-transformed
        # voxel center into the requested view; the MLP's means become a
        # pixel delta (a framework extension of the JAX package).
        self.view_anchored_2d = (
            bool(self.gaussian_config.get("view_anchored", False))
            and gaussian_mode == "2d")

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.net = PoseSplatterNet(
                in_channels=in_channels, out_channels=out_channels,
                base_filters=base_filters, num_unets=num_unets,
                input_size=self.input_size,
                num_gaussian_params=self.num_gaussian_params,
                ablation=ablation, remat=remat_unets)
        self.to(dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.grid.device

    def check_selection(self) -> None:
        """Raise if a selection since the last check left its threshold
        table (``select_gaussians``' device route); clears the flag. One
        read of a device value: callers check once a call, after the work
        they enqueued."""
        if stages.blocking(bool, self.selection_miss):
            self.selection_miss.zero_()
            raise RuntimeError(
                "select_gaussians: an occupancy value lies outside the mask "
                f"threshold table ({TABLE_STEPS} steps of "
                f"{self.mask_threshold_delta} from {self.mask_threshold}) "
                "or fewer than min_n values are counted")

    def _tensor(self, x) -> torch.Tensor:
        return stages.to_device(x, self.device, torch.float32)

    # ------------------------------------------------------------------
    def make_adaptive_fn(self):
        """Host hook of the adaptive camera (``pose_splatter.py:324-343``):
        ``adaptive_fn(mask [C',H,W] numpy) -> (temp_K [C',3,3], seed [3])``,
        the observed views' principal points re-centred on the mask
        medoids' triangulated seed (``adjust_principal_points_to_seed``, in
        numpy). Call it on the loader's numpy masks, before anything goes
        to the device; every forward of an adaptive model (train, eval,
        render) takes its frame's ``temp_K`` and seed."""
        Ks_obs = self.Ks_obs.cpu().numpy()
        Es_obs = self.viewmats_obs.cpu().numpy()

        def adaptive_fn(mask):
            return adjust_principal_points_to_seed(np.asarray(mask), Ks_obs,
                                                   Es_obs)

        return adaptive_fn

    # ------------------------------------------------------------------
    def carve(self, mask, img, p_3d, angle, K_mask=None) -> torch.Tensor:
        """Shape-carve one frame. mask [C',H,W]; img [C',H,W,3] (observed
        views only) → volume [4, n1, n2, n3]. ``K_mask`` [C',3,3] replaces
        the intrinsics of the mask's projection (the adaptive ``temp_K``)."""
        return carve_volume(
            self._tensor(mask), self._tensor(img), self._tensor(p_3d),
            self._tensor(angle), self.grid,
            None if K_mask is None else self._tensor(K_mask), self.Ks_obs,
            self.viewmats_obs, volume_fill_color=self.volume_fill_color,
            visibility_cap=self.carve_visibility_cap)

    # ------------------------------------------------------------------
    def frame_gaussians(self, mask, img, center, angle, K_mask=None,
                        new_stats=None):
        """Carve → U-Nets → Gaussian head for one frame, the carve grid at
        ``center``: the head's Gaussians (:meth:`gaussians_from_volume`, not
        yet posed) and the flat indices [max_n] of the voxels selected for
        them (``valid`` marks the real ones). ``new_stats`` as in
        :meth:`PoseSplatterNet.process_volume`. Ends the stages "carve"
        and "unets" and starts "select_head", which the caller ends."""
        stages.begin("carve")
        volume = self.carve(mask, img, center, angle, K_mask)  # [4,n1,n2,n3]
        stages.end("carve", then="unets")
        vol_flat = self.net.process_volume(volume.permute(1, 2, 3, 0)[None],
                                           new_stats)
        stages.end("unets", then="select_head")
        sel = self._select(vol_flat)
        return self._gaussians_from_selection(vol_flat, sel), sel.indices

    def _select(self, vol_flat: torch.Tensor):
        sel = select_gaussians(
            vol_flat[0], self.min_n, self.max_n, self.prob_threshold,
            self.mask_threshold, self.mask_threshold_delta)
        self.selection_miss.logical_or_(sel.table_miss)
        return sel

    def gaussians_from_volume(self, vol_flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """vol_flat [out_ch, N] → dict of Gaussian parameters: world-space
        in 3D mode (``pose_splatter.py:397-414``), pixel-space in 2D."""
        return self._gaussians_from_selection(vol_flat, self._select(vol_flat))

    def _gaussians_from_selection(self, vol_flat, sel) -> Dict[str, torch.Tensor]:
        feats = take_rows_unique(vol_flat.T, sel.indices)  # [max_n, out_ch]
        net_out = self.net.gaussian_head(feats)

        pt = self.prob_threshold
        logit_opac = torch.logit(torch.clamp(
            (1.0 / (1.0 - pt)) * (sel.probs - pt), 1e-6, 1.0 - 1e-6))
        scale_param = self.net.scale[0]
        if self.gaussian_mode == "3d":
            quats, scales, _opac, colors, delta_means = torch.split(
                net_out, [4, 3, 1, 3, 3], dim=1)
            colors = torch.clamp(torch.sigmoid(colors), self.color_clip[0],
                                 self.color_clip[1])
            base = self.grid.reshape(-1, 3)[sel.indices]
            return dict(
                means=base + 2.0 * self.voxel_size * torch.tanh(delta_means),
                log_scales=scales + scale_param,
                quats=quats,
                colors=colors,
                logit_opacities=logit_opac,
                valid=sel.valid,
            )
        means2d, scales2d, rotation, colors, _opac = torch.split(
            net_out, [2, 2, 1, 3, 1], dim=1)
        colors = torch.clamp(torch.sigmoid(colors), self.color_clip[0],
                             self.color_clip[1])
        out = dict(
            means2d=means2d,
            log_scales2d=scales2d + scale_param,
            rotation=rotation[:, 0],
            colors=colors,
            logit_opacities=logit_opac,
            valid=sel.valid,
        )
        if self.view_anchored_2d:
            out["anchor_means"] = self.grid.reshape(-1, 3)[sel.indices]
        return out

    # ------------------------------------------------------------------
    def apply_pose_transform_3d(self, g: Dict[str, torch.Tensor], angle, p_3d):
        """Yaw-rotate and translate world-space Gaussians: means by the yaw
        matrix, quaternions by the yaw quaternion (``pose_splatter.py:439-445``)."""
        angle = self._tensor(angle)
        g = dict(g)
        g["means"] = g["means"] @ yaw_rotation(angle).T + self._tensor(p_3d)
        g["quats"] = rotate_quats_by_yaw(g["quats"], angle)
        return g

    # ------------------------------------------------------------------
    def render(self, g: Dict[str, torch.Tensor], view_idx, K_override=None):
        """Render to the cameras in ``view_idx`` (int or [B] ints), with
        ``K_override`` [C,3,3] in place of the cameras' intrinsics where
        given (3D and anchored 2D; ``pose_splatter.py:448-527``).
        Returns rgb [B,H,W,3], alpha [B,H,W], overflow [] (instances
        dropped by finite binning capacity)."""
        view_idx = stages.to_device(view_idx, self.device).reshape(-1).long()
        Ks = self.Ks if K_override is None else K_override
        if self.gaussian_mode == "3d":
            return rasterize(
                g["means"], g["quats"], torch.exp(g["log_scales"]),
                torch.sigmoid(g["logit_opacities"]), g["colors"],
                self.viewmats[view_idx], Ks[view_idx], self.W, self.H,
                valid=g["valid"], backgrounds=self.background_color,
                tile_shape=self.tile_shape, tile_capacity=self.tile_capacity,
                tile_expand=self.tile_expand, mode=self.render_mode,
                return_overflow=True, instance_cap=self.instance_cap)
        B = view_idx.shape[0]
        if "anchor_means" in g:
            pix = project_points(g["anchor_means"], Ks[view_idx],
                                 self.viewmats[view_idx], clamp_z=True)
            means = pix + g["means2d"][None]  # [B,N,2]
        else:
            means = g["means2d"]
        rgb, alpha, overflow = rasterize_2d(
            means, torch.exp(g["log_scales2d"]), g["rotation"],
            torch.sigmoid(g["logit_opacities"]), g["colors"], self.W, self.H,
            valid=g["valid"], background=self.background_color,
            sigma_cutoff=self.sigma_cutoff, tile_shape=self.tile_shape,
            tile_capacity=self.tile_capacity, tile_expand=self.tile_expand,
            mode=self.render_mode, return_overflow=True)
        if "anchor_means" not in g:
            rgb = rgb[None].expand(B, *rgb.shape)
            alpha = alpha[None].expand(B, *alpha.shape)
        return rgb, alpha, overflow

    # ------------------------------------------------------------------
    def forward(self, mask, img, p_3d, angle, view_idx, train: bool = False,
                return_overflow: bool = False, K_mask=None, carve_center=None):
        """Forward for one frame (``pose_splatter.py:529-595``).

        mask [C',H,W]; img [C',H,W,3] (observed views, channel-last);
        p_3d [3]; angle scalar; view_idx int or [B] ints.
        ``K_mask`` [C',3,3] and ``carve_center`` [3]: an adaptive model's
        ``temp_K`` and seed for this frame (:meth:`make_adaptive_fn`). The
        carve grid sits at ``carve_center``; the pose transform keeps
        ``p_3d``; ``temp_K`` drives the mask's projection and the render of
        the observed views (the holdout views keep their intrinsics). Such
        a forward keeps ``stages.adaptive``'s record.

        Eval (the default): no graph, BN on the running statistics; returns
        rgb [B,H,W,3], alpha [B,H,W] (+ overflow [] if requested).

        ``train=True``: the graph for the backward, BN on batch statistics;
        returns rgb, alpha, the updated running statistics (a dict by
        buffer name; the buffers are not written) and the overflow, as the
        JAX forward with ``mutable=["batch_stats"]`` does.

        The eval forward checks the selection's table flag before it
        returns (not while a CUDA graph captures it); in train mode the
        train step checks it once a step, or a call of K steps.
        """
        with _FRAME:
            if train:
                return self._forward(mask, img, p_3d, angle, view_idx, {},
                                     K_mask, carve_center)
            with torch.no_grad():
                rgb, alpha, _, overflow = self._forward(
                    mask, img, p_3d, angle, view_idx, None, K_mask,
                    carve_center)
            if not (self.device.type == "cuda"
                    and torch.cuda.is_current_stream_capturing()):
                self.check_selection()
        if return_overflow:
            return rgb, alpha, overflow
        return rgb, alpha

    def _forward(self, mask, img, p_3d, angle, view_idx, new_stats,
                 K_mask=None, carve_center=None):
        center = p_3d if carve_center is None else carve_center
        if K_mask is not None:
            # Each on the device once, for the carve, the record and the
            # render alike.
            K_mask, center, p_3d = (self._tensor(x) for x in (K_mask, center,
                                                               p_3d))
            stages.adaptive(K_mask, self.Ks_obs, center, p_3d, self.voxel_size)
        g, _ = self.frame_gaussians(mask, img, center, angle, K_mask,
                                    new_stats)
        if self.gaussian_mode == "3d":
            g = self.apply_pose_transform_3d(g, angle, p_3d)
        elif "anchor_means" in g:
            # Pose-transform the anchors only (deltas/scales stay as-is).
            rot = yaw_rotation(self._tensor(angle))
            g["anchor_means"] = g["anchor_means"] @ rot.T + self._tensor(p_3d)
        stages.end("select_head", g, then="binning")
        # The observed views' temp_K in a copy of the camera set: the
        # model's own intrinsics stay as they are for later frames and for
        # the holdout views.
        K_override = None if K_mask is None else self.Ks.index_copy(
            0, self.obs_index, self._tensor(K_mask))
        rgb, alpha, overflow = self.render(g, view_idx, K_override)
        return rgb, alpha, new_stats, overflow

    # ------------------------------------------------------------------
    def splat(self, means, quats, scales, opacities, colors, viewmats, Ks,
              width: int, height: int, valid=None, radius_clip: float = 2.0,
              tile_expand: Optional[int] = None,
              instance_cap: Optional[int] = None):
        """Render given world-space Gaussians (linear scales, opacities in
        [0, 1]) to cameras viewmats [B,4,4] / Ks [B,3,3] at any size
        (``pose_splatter.py:598-634``): the background by transmittance,
        the colour clipped to [0, 1]. ``tile_expand`` (default the model's)
        and ``instance_cap`` (rows a camera, default 4·N + T·G) are the
        binning's caps. Returns rgb [B,H,W,3], alpha [B,H,W]."""
        rgb, alpha = rasterize(
            means, quats, scales, opacities, colors, viewmats, Ks, width,
            height, valid=valid, backgrounds=None, near_plane=0.01,
            far_plane=1e10, radius_clip=radius_clip, mode=self.render_mode,
            tile_shape=self.tile_shape, tile_capacity=self.tile_capacity,
            tile_expand=tile_expand or self.tile_expand,
            instance_cap=instance_cap)
        rgb = rgb + (1.0 - alpha[..., None]) * self.background_color
        return torch.clamp(rgb, 0.0, 1.0), alpha
