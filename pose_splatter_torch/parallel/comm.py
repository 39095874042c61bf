"""Collectives over a mesh axis that autograd sees.

``torch.distributed``'s collectives write in place and autograd does not
see them: used inside a loss they leave the gradient short by the axis
size or without the halo's share. These are autograd functions with the
transposes JAX's ``shard_map`` uses (``check_rep=False``):

- :func:`psum`: the sum over the axis; backward, the sum of the
  cotangents over the axis;
- :func:`pmean`: ``psum / n``;
- :func:`ppermute`: rank d receives rank d + hop's tensor (zeros where no
  rank sends); backward, the cotangent goes back the opposite way;
- :func:`replicated` / :func:`gather_strips`: a replicated input that
  each rank uses on its own share of the work (identity forward, sum of
  the cotangents backward), and the shares gathered into one tensor on
  every rank (all-gather forward, this rank's slice of the cotangent
  backward): the two ends of a sharded computation whose loss every rank
  computes whole.

``mean_over`` averages a list of tensors over an axis in one flat bucket,
outside autograd (the gradients, BN statistics and metrics of a step).
On a mesh without a process group each is the identity (a ppermute by a
hop receives zeros: no rank sends).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from pose_splatter_torch.parallel.mesh import Mesh


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    y = x.detach().clone().contiguous()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def _shift(x: torch.Tensor, group, n: int, hop: int) -> torch.Tensor:
    """Rank d of the group (of n) receives rank d + hop's ``x``; zeros where
    d + hop is outside the group."""
    me = dist.get_group_rank(group, dist.get_rank())
    out = torch.zeros_like(x)
    x = x.detach().contiguous()
    ops = []
    if 0 <= me + hop < n:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, me + hop), group))
    if 0 <= me - hop < n:
        ops.append(dist.P2POp(dist.isend, x,
                              dist.get_global_rank(group, me - hop), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, hop):
        ctx.cfg = (group, n, hop)
        return _shift(x, group, n, hop)

    @staticmethod
    def backward(ctx, g):
        group, n, hop = ctx.cfg
        return _shift(g, group, n, -hop), None, None, None


class _GatherStrips(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.cfg = (dist.get_group_rank(group, dist.get_rank()), x.shape[dim],
                   dim)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.detach().contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        me, size, dim = ctx.cfg
        return g.narrow(dim, me * size, size), None, None, None


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum of ``x`` over ``axis`` (``jax.lax.psum``)."""
    group = mesh.group(axis)
    return x if group is None else _Psum.apply(x, group)


def pmean(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Mean of ``x`` over ``axis`` (``jax.lax.pmean``)."""
    return psum(x, mesh, axis) / mesh.shape[axis]


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str, hop: int) -> torch.Tensor:
    """``jax.lax.ppermute`` with the pairs (d + hop → d): rank d of the
    axis receives rank d + hop's ``x``, and zeros where there is no such
    rank."""
    group = mesh.group(axis)
    if group is None:
        return torch.zeros_like(x) if hop else x
    return _Ppermute.apply(x, group, mesh.shape[axis], hop)


def replicated(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``x``, the same on every rank of ``axis``, entering work that each
    rank does on its own share: its gradient is summed over the axis."""
    group = mesh.group(axis)
    return x if group is None else _Replicated.apply(x, group)


def gather_strips(x: torch.Tensor, mesh: Mesh, axis: str,
                  dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in axis order (the
    all-gather of a ``shard_map`` output sharded on ``dim``); backward,
    this rank's slice of the cotangent."""
    group = mesh.group(axis)
    return x if group is None else _GatherStrips.apply(
        x, group, mesh.shape[axis], dim)


def mean_over(tensors: Sequence[torch.Tensor], mesh: Mesh,
              axis: str) -> List[torch.Tensor]:
    """The tensors averaged over ``axis``: one all-reduce of one flat
    float32 bucket (no autograd)."""
    group = mesh.group(axis)
    if group is None or not tensors:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= mesh.shape[axis]
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


def broadcast_(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Copy the tensors of the mesh's first rank into every rank's of the
    mesh, in place (no autograd). A tensor off the group's device (Adam's
    step count on the host under NCCL) goes through a copy on it."""
    group = mesh.group(None)
    if group is None:
        return
    src = int(mesh.devices.reshape(-1)[0])
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    for t in tensors:
        buf = t.detach().to(dev).contiguous()
        dist.broadcast(buf, src=src, group=group)
        if buf.data_ptr() != t.data_ptr():
            with torch.no_grad():
                t.copy_(buf)
