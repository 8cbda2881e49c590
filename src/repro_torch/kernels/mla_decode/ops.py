"""Host layer around the MLA latent decode kernel: the split-KV segment
count of a launch, chosen from the shapes alone.

A decode step of few sequences gives the kernel few blocks (one per 64
heads and sequence: 16 at deepseek-v2's 128 heads and 8 sequences), too
few for the card's SMs, so the keys of each sequence are cut into
segments while the grid still fits in one wave (at most one block per
SM: the kernel takes a whole SM's shared memory), each segment at least
`MIN_SEG_TILES` tiles long.  The choice reads no device data (the
context lengths stay on the card), so the step captures into a CUDA
graph; segments past a row's context exit at once.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.mla_decode import kernel as K
from repro_torch.utils.misc import cdiv

HEADS_PER_BLOCK = 64  # the bf16 kernel's heads a block: one wgmma M tile
MIN_SEG_TILES = 4     # tiles of K.SEG_ALIGN keys a segment at least


def _sm_count(device: torch.device) -> int:
    if device.type != "cuda":
        return 1
    return torch.cuda.get_device_properties(device).multi_processor_count


def split(s: int, h: int, keys: int, sms: int) -> tuple[int, int]:
    """(num_segments, seg_keys) for S sequences of H heads over `keys`
    page-table keys on a card of `sms` SMs."""
    blocks = s * cdiv(h, HEADS_PER_BLOCK)
    tiles = cdiv(max(keys, 1), K.SEG_ALIGN)
    nseg = max(1, min(sms // max(blocks, 1), tiles // MIN_SEG_TILES))
    seg_keys = cdiv(tiles, nseg) * K.SEG_ALIGN
    return cdiv(tiles * K.SEG_ALIGN, seg_keys), seg_keys


def mla_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                         page_table: torch.Tensor,
                         context_lens: torch.Tensor, *, v_dim: int,
                         scale: float) -> torch.Tensor:
    """q [S, H, D]; k_pages [P, ps, D] (one pool of [latent | k_rope]
    rows); page_table [S, Np]; context_lens [S].  Returns [S, H, v_dim]."""
    s_, h, _ = q.shape
    nseg, seg_keys = split(s_, h, page_table.shape[1] * k_pages.shape[1],
                           _sm_count(q.device))
    return K.mla_decode(
        q.contiguous(), k_pages, page_table.to(torch.int32).contiguous(),
        context_lens.to(torch.int32).contiguous(), v_dim=v_dim, scale=scale,
        num_segments=nseg, seg_keys=seg_keys)
