"""Attention backend: the unified token-packed entry of the engine step.

The JAX reference switches between a `pallas` backend (its kernels) and an
`xla` pure-jnp reference.  The port has no such switch: the kernel
wrappers pick the path from the tensors' device — a CUDA tensor runs the
hand-written CUDA kernels, a CPU tensor their plain PyTorch versions.
"""
from __future__ import annotations

import torch

from repro_torch.core.attention import heuristics
from repro_torch.core.paged.kv_cache import require_single_pool
from repro_torch.kernels.paged_attention import ops as paged_ops


def unified_attention(
    q: torch.Tensor,  # [T, Hq, Dk] token-packed, decode rows first
    k_pages: torch.Tensor,  # [Hkv, 1, P, ps, Dk]
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [S, Np]
    context_lens: torch.Tensor,  # [S]
    query_start_loc: torch.Tensor,  # [S+1]
    query_lens: torch.Tensor,  # [S]
    *,
    num_decode_seqs: int = 0,
    scale: float | None = None,
    kernel_cfg: heuristics.KernelConfig | None = None,
) -> torch.Tensor:
    """ONE launch over a token-packed batch mixing decode rows (q = 1),
    fresh prefill chunks (context == query) and resumed chunks (context >
    query).  Sequences [0, num_decode_seqs) are the static decode region
    (one token row each, dead slots `context_lens == 0`); the remaining
    sequences are ragged chunks packed behind them."""
    cfg = heuristics.validate(
        kernel_cfg or heuristics.KernelConfig("gqa"), k_pages.shape[3])
    require_single_pool(k_pages, "unified_attention")
    return paged_ops.paged_attention_unified(
        q, k_pages[:, 0], v_pages[:, 0], page_table, context_lens,
        query_start_loc, query_lens, num_decode_seqs=num_decode_seqs,
        variant=cfg.variant, tile=cfg.tile, num_segments=cfg.num_segments,
        block_q=cfg.block_q, scale=scale,
    )
