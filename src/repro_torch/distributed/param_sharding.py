"""Serving tensor parallelism: which parameters and cache leaves a rank
holds a block of, and the cutting of them (the serving half of the
reference's `distributed/param_sharding.py`).

Only the projections whose OUTPUT dim is whole attention heads are split:
`wq`, `wk`, `wv` (weights w [d, H Dh] and biases b [H Dh]) column-parallel,
rank r holding heads [r H / tp, (r + 1) H / tp).  Each rank computes its
own head block end to end, the KV pages split on the same head axis, and
one all-gather of the attention output reassembles the full head set
before the replicated `wo`.  No contraction is split, so a rank computes
what one device computes.  A fused `wqkv` stays replicated (its output
interleaves q | k | v, so a contiguous split would not land on head
boundaries); the attention layer slices its local heads after the
projection.  Everything else (norms, `wo`, the MLP, the embedding and the
head) is replicated, and so is a MoE layer's router and shared experts;
its expert stacks are cut to E / n a rank where the layer serves expert
parallel (`shard_serve_experts`).  Each rank's KV pool is allocated at its
own Hkv / tp heads (`models.model.make_cache(tp=)`).

Training on a (data, model) mesh (the reference's `param_spec` family,
path + shape rules with divisibility guards):

  * expert weights (w_gate / w_up / w_down, [E, d, ff]): E on 'model'
    (expert parallelism), d on the FSDP data axes when enabled;
  * the embedding table [V, d]: V on 'model' (vocab-parallel logits), d
    on the FSDP axes;
  * other >= 2-D weights: of the last two dims, the larger-priority
    divisible dim goes on 'model' (the output dim first: column-parallel;
    the input dim first for the row-parallel `wo`, `down`, `out_proj`),
    the other on the FSDP axes when divisible (ZeRO-3);
  * 1-D leaves (norm scales, biases, gate vectors): replicated.

The reference stacks each block group's leaves on a leading [L] axis and
applies these rules to the stacked leaf, so a stacked 1-D leaf ([L, n])
takes the generic rule on (L, n); the port holds the leaf unstacked and
takes the reference's spec less its [L] entry (`stacked=L`).  The AdamW
moments inherit their parameter's layout.  A spec is the reference's
PartitionSpec as a tuple: per dim None, "model", or the batch axes.

The serving cache on that mesh (`cache_spec`, the reference's): KV pages
[L, Hkv, pools, P, ps, D] with the pools on the batch axes (a pool a
data-parallel shard) and Hkv on 'model' where it divides; state caches
[L, B, ...] with B on the batch axes and dim 2 on 'model' where they
divide.  One deliberate difference: where Hkv does not divide 'model'
the reference splits the pages' head_dim (`KV_HEADDIM_SHARD`), which
puts a partial sum inside the attention scores that the paged kernels'
fused softmax cannot take; the port keeps those pages whole within the
pool, the reference's own named alternative (`KV_HEADDIM_SHARD =
False`; `kv_layout` says which a cell has).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.core.paged.kv_cache import ShardingError, local_kv_heads
from repro_torch.distributed import spmd
from repro_torch.models.moe import MoE, shard_experts

SERVE_HEAD_PARALLEL = ("wq", "wk", "wv")


def serve_param_spec(name: str, shape, *, tp: int) -> int | None:
    """The dim of parameter `name` (a `named_parameters` name) split over
    `tp` ranks, or None where it is replicated: the last (output, head)
    dim of the `wq` / `wk` / `wv` weights and biases."""
    if tp == 1 or len(shape) < 1:
        return None
    parts = name.split(".")
    if any(n in parts[:-1] for n in SERVE_HEAD_PARALLEL) \
            and shape[-1] % tp == 0:
        return len(shape) - 1
    return None


def serve_param_specs(model: nn.Module, *, tp: int) -> dict:
    """{name: split dim or None} over the model's parameters."""
    return {name: serve_param_spec(name, p.shape, tp=tp)
            for name, p in model.named_parameters()}


def shard_serve_params(model: nn.Module, tp: int, rank: int) -> nn.Module:
    """Cut, in place, rank `rank`'s whole-head column block of every `wq`
    / `wk` / `wv` weight and bias of `model`; returns the model.  Every
    other parameter stays whole.  A leaf already holding one rank's heads
    (a model an earlier engine of the same group cut) stays as it is."""
    cfg = model.cfg
    local_kv_heads(cfg.num_kv_heads, tp, num_q_heads=cfg.num_q_heads)
    dh = cfg.resolved_head_dim
    for name, p in list(model.named_parameters()):
        if tp == 1 or serve_param_spec(name, p.shape, tp=tp) is None:
            continue
        module_name, leaf = name.rsplit(".", 1)
        proj = module_name.rsplit(".", 1)[-1]
        full = (cfg.num_q_heads if proj == "wq" else cfg.num_kv_heads) * dh
        if p.shape[-1] == full // tp:
            continue
        if p.shape[-1] != full:
            raise ValueError(f"{name}: width {p.shape[-1]} is neither the "
                             f"full {full} nor one rank's {full // tp}")
        # a new tensor: the full one is freed
        block = p.data[..., rank * full // tp:(rank + 1) * full // tp]
        setattr(model.get_submodule(module_name), leaf, nn.Parameter(
            block.clone(), requires_grad=p.requires_grad))
    return model


def shard_serve_experts(model: nn.Module, group) -> nn.Module:
    """Cut, in place, the expert stacks of every MoE layer of `model` whose
    config sets `moe_ep_serve` to this rank's block of E / n experts over
    the process group `group` (`moe.shard_experts`); returns the model.  A
    layer whose E does not divide over the group keeps every expert (its
    `moe_ffn_dropless_ep` falls back to the plain form), as does one an
    earlier call cut."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    for moe in model.modules():
        if isinstance(moe, MoE) and moe.ep_serve and n > 1 \
                and moe.num_experts % n == 0 \
                and moe.w_gate.shape[0] == moe.num_experts:
            shard_experts(moe, n, rank)
    return model


# ---------------------------------------------------------------------------
# Training: FSDP / tensor-parallel placement on the (data, model) mesh
# ---------------------------------------------------------------------------

EXPERT_NAMES = ("w_gate", "w_up", "w_down")

# Megatron pairing: column-parallel ops shard the OUTPUT dim (no comm),
# row-parallel ops shard the INPUT dim (their input arrives already sharded
# from the preceding column-parallel op; one reduction closes the block).
ROW_PARALLEL = ("wo", "down", "out_proj")


def _axes_size(mesh_shape, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh_shape[a]
    return n


def param_spec(name: str, shape, *, mesh_shape, fsdp: bool,
               batch_axes: tuple, stacked: int | None = None) -> tuple:
    """The reference's `param_spec` of the port's parameter `name` (a
    `named_parameters` name) of `shape`: for each dim None, "model" or the
    batch axes.  `mesh_shape` maps each mesh axis to its size (the
    reference reads nothing else of the mesh); `stacked` is the length of
    the reference's leading [L] axis where the reference stacks this leaf
    (the spec is computed on the stacked shape, then its [L] entry
    dropped)."""
    shape = ((stacked,) if stacked else ()) + tuple(shape)
    parts = name.split(".")
    ndim = len(shape)
    model_n = mesh_shape["model"]
    data_n = _axes_size(mesh_shape, batch_axes)
    wdata = tuple(batch_axes) if fsdp else None
    spec: list = [None] * ndim
    if ndim == 0:
        return ()
    if parts[-1] in EXPERT_NAMES and ndim >= 3:  # [(L,) E, d, ff]
        e_dim = ndim - 3
        if shape[e_dim] % model_n == 0:
            spec[e_dim] = "model"
        if wdata and shape[e_dim + 1] % data_n == 0:
            spec[e_dim + 1] = wdata
    elif ndim > 1:
        d0, d1 = ndim - 2, ndim - 1
        # embedding table [V, d]: vocab-parallel; row-parallel: input
        # dim first; else the output dim first (column-parallel)
        if parts == ["embed"] or any(n in parts for n in ROW_PARALLEL):
            cand = [d0, d1]
        else:
            cand = [d1, d0]
        model_dim = next((i for i in cand if shape[i] % model_n == 0), None)
        if model_dim is not None:
            spec[model_dim] = "model"
        if wdata:
            other = d0 if model_dim == d1 else d1
            if other != model_dim and shape[other] % data_n == 0:
                spec[other] = wdata
    return tuple(spec[1:] if stacked else spec)


def reference_stacks(model: nn.Module) -> dict:
    """{parameter name: the length of the reference's stacked [L] axis, or
    None where the reference holds the leaf unstacked}."""
    from repro_torch.weights import _leaves

    counts: dict = {}
    leaves = list(_leaves(model))
    for path, i, _ in leaves:
        if i is not None:
            counts[path] = counts.get(path, 0) + 1
    by_id = {id(t): (counts[path] if i is not None else None)
             for path, i, t in leaves}
    return {name: by_id[id(p)] for name, p in model.named_parameters()}


def _mesh_axes(entry):
    """A spec entry as mesh axes: None, or a tuple of axis names."""
    if entry is None:
        return None
    return (entry,) if isinstance(entry, str) else tuple(entry)


def cut_block(t: torch.Tensor, axes_spec, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor t at layout `axes_spec`."""
    for dim, axes in enumerate(axes_spec):
        if axes:
            n = mesh.size(axes)
            size = t.shape[dim] // n
            t = t.narrow(dim, mesh.index(axes) * size, size)
    return t


def param_layouts(model: nn.Module, *, mesh_shape, fsdp: bool,
                  batch_axes: tuple) -> dict:
    """{parameter name: its layout (per dim None or the mesh axes it is
    split over)} of a model held whole, from `param_spec`."""
    stacks = reference_stacks(model)
    return {name: tuple(_mesh_axes(e) for e in param_spec(
        name, p.shape, mesh_shape=mesh_shape, fsdp=fsdp,
        batch_axes=batch_axes, stacked=stacks[name]))
        for name, p in model.named_parameters()}


@torch.no_grad()
def assign_param_shardings(model: nn.Module, *, mesh, fsdp: bool,
                           batch_axes: tuple, opt_state: dict | None = None
                           ) -> nn.Module:
    """Place, in place, every parameter of `model` (held whole) at its
    `param_spec` on `mesh`: each becomes a new parameter holding only this
    rank's block, the whole one freed, its layout on it
    (`spmd.placement`).  `opt_state` ({"mu", "nu"} lists in parameter
    order, whole) has its moments cut the same way.  Returns the model."""
    layouts = param_layouts(model, mesh_shape=mesh.shape, fsdp=fsdp,
                            batch_axes=batch_axes)
    named = list(model.named_parameters())
    for i, (name, p) in enumerate(named):
        axes_spec = layouts[name]
        module_name, _, leaf = name.rpartition(".")
        module = model.get_submodule(module_name) if module_name else model
        block = nn.Parameter(cut_block(p.data, axes_spec, mesh).clone(),
                             requires_grad=p.requires_grad)
        setattr(module, leaf, spmd.set_placement(block, axes_spec))
        if opt_state is not None:
            for key in ("mu", "nu"):
                opt_state[key][i] = spmd.set_placement(
                    cut_block(opt_state[key][i], axes_spec, mesh).clone(),
                    axes_spec)
    return model


def batch_spec(key: str, shape, *, mesh_shape, batch_axes: tuple) -> tuple:
    """The reference's `batch_spec`: the batch dim (dim 1 of M-RoPE's [3,
    B, S] positions, else dim 0) on the batch axes where it divides."""
    bdim = 1 if key == "positions" and len(shape) == 3 else 0
    spec: list = [None] * len(shape)
    if shape[bdim] % _axes_size(mesh_shape, batch_axes) == 0:
        spec[bdim] = tuple(batch_axes)
    return tuple(spec)


def assign_batch_shardings(batch: dict, *, mesh, batch_axes: tuple) -> dict:
    """This rank's block of every entry of a global batch at its
    `batch_spec` (the reference's device_put against its shardings).  A
    batch whose batch dim does not divide stays whole on every rank, as
    in the reference; the mesh trainer refuses one (ShardingError)."""
    out = {}
    for key, v in batch.items():
        spec = batch_spec(key, v.shape, mesh_shape=mesh.shape,
                          batch_axes=batch_axes)
        axes_spec = tuple(_mesh_axes(e) for e in spec)
        out[key] = spmd.set_placement(cut_block(v, axes_spec, mesh), axes_spec)
    return out


def require_batch_split(batch: dict, *, mesh, batch_axes: tuple) -> None:
    """Raise ShardingError unless every entry's batch dim divides over the
    batch axes (the mesh trainer holds the loss's sums per batch shard)."""
    n = _axes_size(mesh.shape, batch_axes)
    for key, v in batch.items():
        spec = batch_spec(key, v.shape, mesh_shape=mesh.shape,
                          batch_axes=batch_axes)
        if not any(spec):
            raise ShardingError(
                f"batch entry {key!r} of shape {tuple(v.shape)} does not "
                f"split over the {n} ranks of the batch axes {batch_axes}: "
                f"use a (micro)batch that is a multiple of {n}")


# ---------------------------------------------------------------------------
# The serving cache on the (data, model) mesh
# ---------------------------------------------------------------------------

def kv_layout(num_kv_heads: int, model_n: int) -> str:
    """How the KV pages split over 'model': "heads" (whole KV heads a
    rank) or "whole" (every rank of 'model' holds every KV head of its
    pool, where the reference splits head_dim)."""
    return "heads" if num_kv_heads % model_n == 0 else "whole"


def cache_spec(path: str, shape, *, mesh_shape, batch_axes: tuple,
               model_axis: str = "model") -> tuple:
    """The reference's `cache_spec` of the port's cache leaf `path`
    ("attn.k_pages", "mamba.ssm", ...) of global `shape`: for each dim
    None, `model_axis` or the batch axes.  KV pages [L, Hkv, pools, P, ps,
    D]: the pools on the batch axes where they divide, Hkv on the model
    axis where it divides, else the pages whole (the reference splits
    their head_dim: module docstring);
    state caches [L, B, ...]: B on the batch axes, dim 2 on the model axis
    where each divides."""
    ndim = len(shape)
    model_n = mesh_shape[model_axis]
    data_n = _axes_size(mesh_shape, batch_axes)
    spec: list = [None] * ndim
    leaf = path.rsplit(".", 1)[-1]
    if leaf in ("k_pages", "v_pages"):
        if batch_axes and shape[2] % data_n == 0:
            spec[2] = tuple(batch_axes)
        if shape[1] % model_n == 0:
            spec[1] = model_axis
        return tuple(spec)
    if ndim >= 2 and batch_axes and shape[1] % data_n == 0:
        spec[1] = tuple(batch_axes)
    if ndim >= 3 and shape[2] % model_n == 0:
        spec[2] = model_axis
    return tuple(spec)


@torch.no_grad()
def assign_cache_shardings(cache: dict, *, mesh, batch_axes: tuple,
                           model_axis: str = "model") -> dict:
    """This rank's block of every leaf of a whole serving cache at its
    `cache_spec`, a new tensor carrying its layout (`spmd.placement`); the
    whole leaves are left to be freed.  The serving steps read and write
    these blocks in place: a layer's pages [Hkv / M or Hkv, 1, P, ps, D]
    (one pool a rank where the pools divide over the batch axes), its
    state rows the rank's batch rows."""
    out = {}
    for g, leaves in cache.items():
        out[g] = {}
        for k, t in leaves.items():
            layout = tuple(_mesh_axes(e) for e in cache_spec(
                f"{g}.{k}", t.shape, mesh_shape=mesh.shape,
                batch_axes=batch_axes, model_axis=model_axis))
            out[g][k] = spmd.set_placement(
                cut_block(t, layout, mesh).clone(), layout)
    return out
