"""Host layer around the grouped expert GEMM: the expert SwiGLU of the
dropless MoE, `silu(xs . Wg[e]) * (xs . Wu[e]) . Wd[e]` over each
expert's rows, as two launches (gate and up fused, then down).

`expert_ffn` is the part of `repro/models/moe.py:moe_ffn_dropless` that
the reference computes with three `jax.lax.ragged_dot`s: rows xs [R, d]
sorted by expert, offsets [E + 1] int32 on the rows' device, weights
w_gate / w_up [E, d, ff] and w_down [E, ff, d].  Returns ys [R, d] in xs's
dtype; h [R, ff] is rounded to xs's dtype between the launches, as the
reference's bf16 ragged_dot rounds it.  `tail=True`: the groups may end
before R, the rows past offsets[E] come out zero (the expert-parallel
MoE's rows of other ranks' experts).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.moe import kernel as K


def expert_ffn(xs: torch.Tensor, offsets: torch.Tensor,
               w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor, *, tail: bool = False) -> torch.Tensor:
    h = K.grouped_gemm(xs, w_gate, offsets, w_up, tail=tail)
    return K.grouped_gemm(h, w_down, offsets, tail=tail)
