"""Where a rank sits in a tensor- or expert-parallel group.

`ShardCtx` is threaded through `apply_unified` into the attention layers,
so per-rank code knows how many ways the head axis was split, which block
of heads is its own, and which `torch.distributed` group to all-gather
over (the reference's `ShardCtx`, which names a mesh axis where the port
holds a process group).  `use_expert_group` makes a process group the
expert-parallel group of the MoE blocks for the calls inside it (the
reference's `use_rules`, which enables `moe_ffn_dropless_ep`).

The reference's logical-axis rules (`make_rules`, `use_rules`,
`constrain`) belong to its GSPMD training path and have no counterpart
here yet.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Position of a rank in the head-parallel group of a serving step.

    `axis` names the split (the reference's mesh axis), `size` the number
    of ranks, `rank` this rank's index in the group (its head block), and
    `group` the `torch.distributed` process group (None: the default
    group).  Frozen, so one context serves every step of an engine."""

    axis: str = "tp"
    size: int = 1
    rank: int = 0
    group: object = None


def gather_ranks(x: torch.Tensor, size: int, group) -> torch.Tensor:
    """[size, *x.shape]: x of every rank of `group` (of `size` ranks), in
    rank order (gathered as [1, *x.shape] blocks along a new dim 0)."""
    x1 = x.contiguous().unsqueeze(0)
    out = x1.new_empty((size,) + tuple(x.shape))
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, x1, group=group)
    return out


def all_gather_heads(x: torch.Tensor, shard: ShardCtx) -> torch.Tensor:
    """x [..., H_loc, D] of each rank's contiguous head block -> [..., size
    * H_loc, D] in rank order: the head set of one device, exactly (the
    reference's tiled `all_gather` on the head axis)."""
    lead, (h, d) = x.shape[:-2], x.shape[-2:]
    out = gather_ranks(x, shard.size, shard.group)
    n = len(lead)
    perm = tuple(range(1, n + 1)) + (0, n + 1, n + 2)
    return out.permute(perm).reshape(*lead, shard.size * h, d)


_state = threading.local()


def expert_group():
    """The expert-parallel process group active in this thread, or None."""
    return getattr(_state, "expert_group", None)


@contextlib.contextmanager
def use_expert_group(group):
    """Run the MoE blocks of the calls inside expert-parallel over `group`
    (where the config sets `moe_ep_serve`)."""
    prev = expert_group()
    _state.expert_group = group
    try:
        yield
    finally:
        _state.expert_group = prev
