"""Gradient collectives with compression for the data-parallel reduce (the
port of the reference's `distributed/collectives.py`, over a
`torch.distributed` process group where the reference names a mesh axis).

  bf16_psum           each leaf cast to bf16, summed over the group
                      (`all_reduce`), cast back: half the bytes on the
                      wire, no state.
  int8_ef_allgather   each leaf plus its error feedback quantised to int8
                      with one fp32 scale a leaf, the int8 values and the
                      scales all-gathered, the dequantised sum taken on
                      every rank; the rounding residual is this rank's
                      new error feedback, so the quantisation noise does
                      not bias the sum over steps.

A tree is a tensor, or a dict / list / tuple of them (any
`torch.utils._pytree` tree); the leaves keep their dtypes.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils import _pytree

from repro_torch.distributed.sharding import gather_ranks
from repro_torch.roofline.analysis import collective


def bf16_psum(tree, group=None):
    """The sum over `group` of every leaf, reduced in bf16."""
    def one(g: torch.Tensor) -> torch.Tensor:
        b = g.to(torch.bfloat16)
        with collective("all-reduce", b.numel() * b.element_size()):
            dist.all_reduce(b, group=group)
        return b.to(g.dtype)
    return _pytree.tree_map(one, tree)


def _quantize_int8(g: torch.Tensor):
    """(q int8, scale fp32 0-d): scale = max(max|g| / 127, 1e-12), q =
    round(g / scale) (half to even) clipped to +-127."""
    scale = torch.clamp(g.abs().max() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_ef_allgather(tree, group, error_feedback):
    """(summed tree, new error feedback): `error_feedback` has the tree's
    structure, fp32 residuals (zeros at step 0)."""
    flat, spec = _pytree.tree_flatten(tree)
    ef_flat = _pytree.tree_leaves(error_feedback)
    if len(ef_flat) != len(flat):
        raise ValueError(f"error feedback has {len(ef_flat)} leaves, the "
                         f"tree {len(flat)}")
    sums, new_ef = [], []
    for g, ef in zip(flat, ef_flat):
        gf = g.float() + ef
        q, scale = _quantize_int8(gf)
        new_ef.append(gf - q.float() * scale)
        n = dist.get_world_size(group)
        qs = gather_ranks(q, n, group)  # [n, ...] int8 on the wire
        ss = gather_ranks(scale, n, group)  # [n] fp32
        total = torch.tensordot(ss, qs.float(), dims=([0], [0]))
        sums.append(total.to(g.dtype))
    return (_pytree.tree_unflatten(sums, spec),
            _pytree.tree_unflatten(new_ef, spec))
