"""GPipe-style pipeline parallelism over the ranks of a process group (the
port of the reference's `distributed/pipeline.py`, whose stages sit on a
'pipe' mesh axis).

Not enabled for any training mesh of the port, as in the reference (every
assigned architecture fits with TP + FSDP), but provided and tested on
host ranks.

Schedule: classic GPipe fill-drain over M microbatches and S stages, one
stage a rank (bubble fraction (S-1)/(M+S-1)).  At tick t stage s works on
microbatch t - s: stage 0 takes it from x, every other stage the
activation stage s - 1 made at tick t - 1; then every stage hands its
activation on.  The hand-off is the reference's `ppermute` (i -> i + 1),
built from an all-gather of every stage's activation, which gloo has for
CPU and CUDA tensors alike.  The last stage's outputs reach every rank
through one all-reduce (the other stages contribute zeros), as the
reference's `psum` does.  Differentiable: each collective's backward is
its adjoint.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils import _pytree

from repro_torch.distributed.sharding import gather_ranks


class _Gather(torch.autograd.Function):
    """[S, *x.shape]: x of every rank of `group`; backward: the sum over
    the ranks of their gradient for this rank's block."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return gather_ranks(x, n, group)

    @staticmethod
    def backward(ctx, g):
        total = g.contiguous().clone()
        dist.all_reduce(total, group=ctx.group)
        return total[dist.get_rank(ctx.group)], None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


def pipeline_apply(stage_fn, stage_params, x: torch.Tensor, *, group=None):
    """y = stage_{S-1}(... stage_0(x)) with stage s on rank s of `group`
    (None: the default group) and `stage_params` this rank's stage's
    parameters (e.g. `stage_split(params, S)` indexed by the rank).  x
    [M, mb, ...] is the microbatched input, the same on every rank.
    Returns [M, mb, ...], the last stage's outputs, on every rank."""
    n = dist.get_world_size(group)
    sid = dist.get_rank(group)
    m = x.shape[0]
    buf = torch.zeros_like(x[0])  # the activation resident on this stage
    outs = [None] * m
    for t in range(m + n - 1):
        mb = t - sid  # the microbatch this stage works on at tick t
        active = 0 <= mb < m
        if active:
            y = stage_fn(stage_params, x[mb] if sid == 0 else buf)
            if sid == n - 1:
                outs[mb] = y
        else:
            y = torch.zeros_like(buf)
        # ppermute i -> i + 1: each stage takes its predecessor's block
        every = _Gather.apply(y, group, n)
        if sid:
            buf = every[sid - 1]
    zero = torch.zeros_like(x[0])
    mine = torch.stack([o if o is not None else zero for o in outs])
    return _Sum.apply(mine, group)


def stage_split(params_stacked, num_stages: int):
    """[L, ...] layer-stacked params (a tensor or a tree of them) -> [S, L
    / S, ...] stage-stacked."""
    return _pytree.tree_map(
        lambda t: t.reshape((num_stages, t.shape[0] // num_stages)
                            + tuple(t.shape[1:])), params_stacked)
