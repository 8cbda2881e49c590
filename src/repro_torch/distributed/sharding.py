"""Logical-axis sharding: model code names axes, the launcher binds rules;
and where a rank sits in a tensor- or expert-parallel serving group.

Training on a (data, model) mesh (the port of the reference's GSPMD
rules).  Model and training code calls `constrain(x, 'batch', 'seq',
'embed', held=...)` at the reference's sites.  Without an active mesh and
rule set (`use_rules`, entered by the launcher) it returns x: the same
model code runs on one device.  With them it moves x from the layout it
is `held` at to the layout the rules give its logical axes, and returns
this rank's block of the result.  GSPMD finds the held layout by
propagation; here the caller states it, since a rank holds a plain local
tensor (no DTensor): `held` names, for each dim, the mesh axes it is split
over (None: whole), and `partial` the mesh axes over which x is a pending
sum (the output of a row-parallel product).  The move uses only
all-gather, all-reduce and slicing (`distributed/spmd.py`, each
differentiable), and keeps the reference's two fallbacks: a dimension
that does not divide by its mesh axes' size stays whole, and so does a
dimension whose mesh axis an earlier dimension already took.

Rule sets (`make_rules`, the reference's table key for key):
  TP-only   heads / ff / vocab / experts on 'model'
  FSDP      + weights on the batch axes too (ZeRO-3), gathered a layer at
            a time where they are used
  sp        the residual stream's sequence axis on 'model' (Megatron
            sequence parallelism): the blocks all-gather it on entry and
            reduce-scatter their outputs back onto it
  pods      the 'pod' axis composes with 'data' for the batch

Serving: `ShardCtx` is threaded through `apply_unified` into the
attention layers, so per-rank code knows how many ways the head axis was
split, which block of heads is its own, and which `torch.distributed`
group to all-gather over (the reference's `ShardCtx`, which names a mesh
axis where the port holds a process group).  `use_expert_group` makes a
process group the expert-parallel group of the MoE blocks for the calls
inside it (the reference's `use_rules`, which enables
`moe_ffn_dropless_ep`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch
import torch.distributed as dist

from repro_torch.roofline.analysis import collective


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
    with collective("all-gather", out.numel() * out.element_size()):
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


# ---------------------------------------------------------------------------
# The training mesh's logical-axis rules
# ---------------------------------------------------------------------------

def _rules() -> dict | None:
    return getattr(_state, "rules", None)


def _mesh():
    return getattr(_state, "mesh", None)


# the architectures the reference trains and serves with their weights
# also split over the data axes (ZeRO-3; the reference's `FSDP_ARCHS`)
FSDP_ARCHS = {"llama3-405b", "llama4-maverick-400b-a17b", "deepseek-v2-236b"}


def uses_fsdp(cfg) -> bool:
    """Whether a config (a registry architecture or its "-reduced" cut)
    splits its weights over the data axes: its parameters' placement and
    its rules' `fsdp` both read this."""
    return cfg.name.split("-reduced")[0] in FSDP_ARCHS


# logical axis -> mesh axes (None = replicated)
def make_rules(*, multi_pod: bool = False, fsdp: bool = False,
               sp: bool = False) -> dict:
    batch = ("pod", "data") if multi_pod else ("data",)
    wdata = batch if fsdp else None  # weight-sharding data axes (ZeRO-3)
    return {
        "batch": batch,
        "seq": None,
        # residual-stream sequence axis (Megatron-style sequence
        # parallelism: shards the remat-saved activations)
        "seq_sp": ("model",) if sp else None,
        "embed": None,
        "heads": ("model",),
        "kv_heads": ("model",),
        "q_lora": None,
        "ff": ("model",),
        "vocab": ("model",),
        "experts": ("model",),
        "expert_cap": None,
        "pages": batch,  # KV pages sharded like the batch that owns them
        "page_slot": None,
        "head_dim": None,
        "state": None,
        # weight-only logical axes
        "w_embed_in": wdata,  # the non-model dim of weight matrices
        "w_stack": None,  # stacked-layer leading dim
    }


@contextlib.contextmanager
def use_rules(mesh, rules: dict):
    """Make `mesh` (`launch.mesh.TrainMesh`) and `rules` the active ones in
    this thread for the calls inside."""
    prev = (_mesh(), _rules())
    _state.mesh, _state.rules = mesh, rules
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev


def checkpoint_contexts():
    """`torch.utils.checkpoint`'s `context_fn` for a block run under the
    active rules: (the forward's context, the recompute's).  The recompute
    runs in the backward, on the autograd engine's worker thread of a
    CUDA device, where these thread-local rules are unset: it re-enters
    the active ones."""
    return contextlib.nullcontext(), use_rules(_mesh(), _rules())


def active() -> bool:
    return _rules() is not None and _mesh() is not None


def active_mesh():
    """The active `TrainMesh` (None without `use_rules`)."""
    return _mesh() if active() else None


def spec(*logical_axes: str | None) -> tuple:
    """The mesh axes of each logical axis under the active rules (the
    reference's PartitionSpec, as a tuple: None or a tuple of axes); all
    None without them (one device holds everything whole)."""
    rules = _rules() if active() else {}
    return tuple(None if ax is None else rules.get(ax)
                 for ax in logical_axes)


def resolve(shape, *logical_axes: str | None) -> tuple:
    """The layout `constrain` gives a tensor of global `shape` under the
    active rules: each dim's mesh axes, None where it is replicated, the
    reference's fallbacks applied (a dim not divisible by its axes' size,
    or whose axis an earlier dim took, stays whole); all None without
    active rules."""
    rules, mesh = _rules(), _mesh()
    if len(shape) != len(logical_axes):
        raise ValueError(f"rank {len(shape)} vs axes {logical_axes}")
    if not active():
        return (None,) * len(shape)
    out, used = [], set()
    for dim, ax in zip(shape, logical_axes):
        mesh_axes = None if ax is None else rules.get(ax)
        if mesh_axes is not None:
            if dim % mesh.size(mesh_axes) or used & set(mesh_axes):
                mesh_axes = None  # non-divisible or axis already used
        if mesh_axes is not None:
            used |= set(mesh_axes)
        out.append(None if mesh_axes is None else tuple(mesh_axes))
    return tuple(out)


def global_shape(x: torch.Tensor, held) -> tuple:
    """The global shape of a local block `x` held at `held`."""
    mesh = _mesh()
    if held is None:
        return tuple(x.shape)
    return tuple(n * (1 if axes is None else mesh.size(axes))
                 for n, axes in zip(x.shape, held))


def constrain(x: torch.Tensor, *logical_axes: str | None, held=None,
              partial: tuple = ()) -> torch.Tensor:
    """This rank's block of x at the rules' layout for `logical_axes`; x
    itself without active rules.  `held` is the layout x is held at (None:
    whole on every rank), `partial` the mesh axes over which x is a
    pending sum.  A pending sum over an axis the new layout splits a dim
    on becomes a reduce-scatter along that dim, else an all-reduce; a dim
    split in `held` but not in the new layout is all-gathered; one split
    in the new layout but not in `held` is sliced."""
    if not active():
        return x
    from repro_torch.distributed import spmd  # the collectives

    mesh = _mesh()
    held = held or (None,) * x.ndim
    if len(held) != x.ndim:
        raise ValueError(f"rank {x.ndim} vs held layout {held}")
    target = resolve(global_shape(x, held), *logical_axes)
    for axis in partial:
        dims = [i for i, (h, t) in enumerate(zip(held, target))
                if t == (axis,) and h is None]
        if dims:  # the sum lands split along that dim
            x = spmd.reduce_scatter(x, dims[0], (axis,))
            held = held[:dims[0]] + ((axis,),) + held[dims[0] + 1:]
        else:
            x = spmd.all_reduce(x, (axis,))
    for i, (h, t) in enumerate(zip(held, target)):
        if h == t:
            continue
        if h is not None:
            x = spmd.all_gather(x, i, h)
        if t is not None:
            n, k = mesh.size(t), mesh.index(t)
            x = x.narrow(i, k * (x.shape[i] // n), x.shape[i] // n)
    return x


def named_sharding(mesh, *logical_axes: str | None) -> tuple:
    """The DTensor placements (one per mesh dim: `Shard(d)` or
    `Replicate()`) of a tensor whose dims carry `logical_axes` under the
    active rules (the reference's NamedSharding of `spec`)."""
    from torch.distributed.tensor import Replicate, Shard

    dims = spec(*logical_axes)
    out = []
    for name in mesh.axis_names:
        hit = [d for d, axes in enumerate(dims) if axes and name in axes]
        out.append(Shard(hit[0]) if hit else Replicate())
    return tuple(out)
