"""Attention backend: the unified token-packed entry of the packed engine
step, and the decode / uniform-prefill entries of the padded per-kind
step.

The JAX reference switches between a `pallas` backend (its kernels) and an
`xla` pure-jnp reference.  The port has no such switch; each entry is the
reference's `pallas` branch, and the kernel wrappers pick the path from
the tensors' device — a CUDA tensor runs the hand-written CUDA kernels, a
CPU tensor their plain PyTorch versions.
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


def decode_attention(
    q: torch.Tensor,  # [S, Hq, Dk]
    k_pages: torch.Tensor,  # [Hkv, 1, P, ps, Dk]
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [S, Np]
    context_lens: torch.Tensor,  # [S]
    *,
    scale: float | None = None,
    kernel_cfg: heuristics.KernelConfig | None = None,
) -> torch.Tensor:
    """Single-token decode over the paged cache (C1-C3 by the config's
    variant); dead rows (context 0) are exact zeros.  Returns [S, Hq, Dv]."""
    require_single_pool(k_pages, "decode_attention")
    cfg = heuristics.validate(
        kernel_cfg or heuristics.KernelConfig("gqa"), k_pages.shape[3])
    return paged_ops.paged_attention_decode(
        q, k_pages[:, 0], v_pages[:, 0], page_table, context_lens,
        variant=cfg.variant, tile=cfg.tile, num_segments=cfg.num_segments,
        scale=scale,
    )


def prefill_attention_uniform(
    q: torch.Tensor,  # [B, S, Hq, Dk]
    query_lens: torch.Tensor,  # [B] (<= S; ragged through padding)
    k_pages: torch.Tensor,  # [Hkv, 1, P, ps, Dk], the chunk already written
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, Np]
    context_lens: torch.Tensor,  # [B]
    *,
    scale: float | None = None,
    kernel_cfg: heuristics.KernelConfig | None = None,
) -> torch.Tensor:
    """Uniform-layout prefill over sequences with NO prior context
    (context_lens == query_lens): the Q-Block prefill kernel reads the
    chunk's KV back from the pages (paper §4.3).  The uniform padded layout
    is the ragged one with stride-S starts.  Returns [B, S, Hq, Dv], zeros
    in padded rows."""
    b, s, hq, dk = q.shape
    require_single_pool(k_pages, "prefill_attention_uniform")
    cfg = heuristics.validate(
        kernel_cfg or heuristics.KernelConfig("gqa"), k_pages.shape[3])
    qsl = torch.arange(b + 1, dtype=torch.int32, device=q.device) * s
    out = paged_ops.paged_attention_prefill(
        q.reshape(b * s, hq, dk), k_pages[:, 0], v_pages[:, 0], page_table,
        context_lens, qsl, query_lens.to(torch.int32), block_q=cfg.block_q,
        tile=cfg.tile, scale=scale,
    )
    return out.reshape(b, s, hq, -1)
