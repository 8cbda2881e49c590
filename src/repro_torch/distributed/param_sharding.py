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

The training half of the reference (FSDP `param_spec`,
`assign_param_shardings`) waits for the port's distributed training.
"""
from __future__ import annotations

import torch.distributed as dist
from torch import nn

from repro_torch.core.paged.kv_cache import local_kv_heads
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
