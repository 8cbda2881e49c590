"""Host layer around the paged-attention kernels.

Responsibilities (mirroring `repro/kernels/paged_attention/ops.py`):
  * reshaping the paged cache [Hkv, P, ps, D] into the tile view
    [Hkv, P, ps // tile, tile, D] (C4: `tile` is any divisor of the page);
  * Q packing for the GQA Q-Block layout (C2, row = tok * group + g) and
    the prefill metadata (cumulative-Q-block tensor + vectorised binary
    search, paper §6.1);
  * variant plumbing: `baseline` / `gqa` / `segmented` (C1/C2/C3);
  * the static decode-region split of the unified launch.

The TPU padding of the reference (head_dim to 128 lanes, rows to 8
sublanes) does not carry over: head_dim 64 runs as 64.  Everything here is
device-agnostic tensor code with no host synchronisation; which kernel
runs (CUDA or the plain version) is decided by the kernel wrappers from
the tensors' device.
"""
from __future__ import annotations

from typing import Literal

import torch

from repro_torch.core.paged.kv_cache import ShardingError
from repro_torch.kernels.paged_attention import kernel as K
from repro_torch.utils.misc import cdiv


def _tile_view(pages: torch.Tensor, tile: int) -> torch.Tensor:
    """[Hkv, P, ps, D] -> [Hkv, P, ps//tile, tile, D] (free reshape)."""
    hkv, p, ps, d = pages.shape
    if ps % tile:
        raise ValueError(f"tile {tile} must divide page_size {ps}")
    return pages.reshape(hkv, p, ps // tile, tile, d)


def default_tile(page_size: int) -> int:
    """Largest multiple-of-8 tile <= min(page_size, 512) dividing page_size."""
    for t in (512, 256, 128, 64, 32, 24, 16, 8):
        if t <= page_size and page_size % t == 0:
            return t
    return page_size


def paged_attention_decode(
    q: torch.Tensor,  # [S, Hq, D]
    k_pages: torch.Tensor,  # [Hkv, P, ps, D]
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [S, Np] int32
    context_lens: torch.Tensor,  # [S] int32
    *,
    variant: Literal["baseline", "gqa", "segmented"] = "gqa",
    tile: int | None = None,
    num_segments: int = 8,
    scale: float | None = None,
) -> torch.Tensor:
    """Single-token decode over the paged KV cache. Returns [S, Hq, D]."""
    s_, hq, d = q.shape
    hkv, p, ps, dk = k_pages.shape
    if dk != d:
        raise ValueError(f"head_dim of q ({d}) and k_pages ({dk}) differ")
    group = hq // hkv
    if scale is None:
        scale = 1.0 / (d**0.5)
    if tile is None:
        tile = default_tile(ps)
    tpp = ps // tile
    num_tiles = page_table.shape[1] * tpp
    kt = _tile_view(k_pages, tile)
    vt = _tile_view(v_pages, tile)
    page_table = page_table.to(torch.int32).contiguous()
    context_lens = context_lens.to(torch.int32).contiguous()

    if variant == "baseline":
        # paper §4.3: one (seq, q_head) per cell; each q head re-streams KV.
        out = K.paged_decode(
            q.reshape(s_, hq, 1, d).contiguous(), kt, vt, page_table,
            context_lens, cells_per_kv=group, scale=scale)
    elif variant == "gqa":
        # paper §4.4: Q-Block = all q heads sharing a KV head.
        out = K.paged_decode(
            q.reshape(s_, hkv, group, d).contiguous(), kt, vt, page_table,
            context_lens, cells_per_kv=1, scale=scale)
    elif variant == "segmented":
        # paper §4.5: parallel tiled softmax + reduction, one launch (the
        # last segment block of a (sequence, KV head) merges).
        nseg = min(num_segments, num_tiles)
        out = K.paged_decode_segmented_merged(
            q.reshape(s_, hkv, group, d).contiguous(), kt, vt, page_table,
            context_lens, num_segments=nseg,
            tiles_per_segment=cdiv(num_tiles, nseg), scale=scale)
    else:
        raise ValueError(f"unknown variant {variant!r}")
    return out.reshape(s_, hq, d)


def build_qblock_metadata(
    query_start_loc: torch.Tensor,  # [S+1] int32
    query_lens: torch.Tensor,  # [S] int32
    context_lens: torch.Tensor,  # [S] int32
    *,
    block_q: int,
    num_q_blocks: int,  # static maximum
):
    """The paper's §6.1 attention metadata: per Q block, the owning
    sequence (binary search over the cumulative-Q-block tensor), the
    block's first-token absolute position, its first packed row and its
    live row count.  Dead blocks get seq = -1.  All int32 [num_q_blocks]."""
    dev = query_lens.device
    i32 = torch.int32
    query_lens = query_lens.to(i32)
    nqb_per_seq = -(-query_lens // block_q)
    cu_qb = torch.cumsum(nqb_per_seq, 0, dtype=i32)  # [S]
    qb = torch.arange(num_q_blocks, dtype=i32, device=dev)
    seq = torch.searchsorted(cu_qb, qb, right=True).to(i32)
    valid = qb < cu_qb[-1]
    seq_c = torch.clamp(seq, max=query_lens.shape[0] - 1).long()
    prev = torch.where(seq_c > 0, cu_qb[torch.clamp(seq_c - 1, min=0)], 0)
    qb_off = qb - prev
    pos0 = context_lens.to(i32)[seq_c] - query_lens[seq_c] + qb_off * block_q
    qb_seq = torch.where(valid, seq_c.to(i32), -1)
    qb_pos0 = torch.where(valid, pos0, 0)
    qb_row0 = torch.where(
        valid, query_start_loc.to(i32)[seq_c] + qb_off * block_q, 0)
    qb_rows = torch.where(
        valid, torch.clamp(query_lens[seq_c] - qb_off * block_q, 0, block_q),
        0)
    return (qb_seq.to(i32), qb_pos0.to(i32), qb_row0.to(i32),
            qb_rows.to(i32))


def paged_attention_prefill(
    q: torch.Tensor,  # [T, Hq, D]
    k_pages: torch.Tensor,  # [Hkv, P, ps, D]
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [S, Np]
    context_lens: torch.Tensor,  # [S]
    query_start_loc: torch.Tensor,  # [S+1]
    query_lens: torch.Tensor,  # [S]
    *,
    block_q: int = 16,
    tile: int | None = None,
    num_q_blocks: int | None = None,  # static; default T//block_q + S
    scale: float | None = None,
) -> torch.Tensor:
    """Chunked-prefill attention over the paged cache (Q-Block kernel, C2).

    The chunk's K/V must already be written to the pages. Returns [T, Hq, D]
    with zeros in dead rows.
    """
    t, hq, d = q.shape
    s_ = query_lens.shape[0]
    hkv, p, ps, _ = k_pages.shape
    group = hq // hkv
    if scale is None:
        scale = 1.0 / (d**0.5)
    if tile is None:
        tile = default_tile(ps)
    if num_q_blocks is None:
        num_q_blocks = t // block_q + s_
    dev = q.device
    page_table = page_table.to(torch.int32).contiguous()
    context_lens = context_lens.to(torch.int32).contiguous()

    qb_seq, qb_pos0, qb_row0, qb_rows = build_qblock_metadata(
        query_start_loc, query_lens, context_lens,
        block_q=block_q, num_q_blocks=num_q_blocks,
    )

    # ---- pack Q into [NQB, Hkv, BM, D], row = tok*group + g ----
    tok = torch.arange(block_q, dtype=torch.int32, device=dev)
    rows = qb_row0[:, None] + tok[None, :]  # [NQB, BQ]
    row_live = tok[None, :] < qb_rows[:, None]
    rows_safe = torch.where(row_live, torch.clamp(rows, max=t - 1), 0).long()
    qg = q.reshape(t, hkv, group, d)
    q_packed = qg[rows_safe]  # [NQB, BQ, Hkv, G, D]
    q_packed = torch.where(row_live[:, :, None, None, None], q_packed,
                           torch.zeros((), dtype=q.dtype, device=dev))
    bm = block_q * group
    q_packed = q_packed.permute(0, 2, 1, 3, 4).reshape(
        num_q_blocks, hkv, bm, d).contiguous()

    o_packed = K.paged_prefill_qblock(
        q_packed, _tile_view(k_pages, tile), _tile_view(v_pages, tile),
        qb_seq.contiguous(), qb_pos0.contiguous(), page_table, context_lens,
        block_q=block_q, group=group, scale=scale,
    )

    # ---- scatter back to [T, Hq, D]; dead rows -> the dropped row T ----
    o_packed = o_packed.reshape(num_q_blocks, hkv, block_q, group, d)
    o_packed = o_packed.permute(0, 2, 1, 3, 4)  # [NQB, BQ, Hkv, G, D]
    scatter_rows = torch.where(row_live, rows, t).long()
    out = torch.zeros((t + 1, hkv, group, d), dtype=q.dtype, device=dev)
    out[scatter_rows.reshape(-1)] = o_packed.reshape(
        num_q_blocks * block_q, hkv, group, d)
    return out[:t].reshape(t, hq, d)


def paged_attention_unified(
    q: torch.Tensor,  # [T, Hq, D] token-packed: decode rows first, then chunks
    k_pages: torch.Tensor,  # [Hkv, P, ps, D]
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [S, Np]
    context_lens: torch.Tensor,  # [S]
    query_start_loc: torch.Tensor,  # [S+1]
    query_lens: torch.Tensor,  # [S]
    *,
    num_decode_seqs: int = 0,
    variant: Literal["baseline", "gqa", "segmented"] = "gqa",
    tile: int | None = None,
    num_segments: int = 8,
    block_q: int = 16,
    num_q_blocks: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """One token-packed step: the first `num_decode_seqs` sequences are
    the STATIC decode region (one row each, `query_start_loc[i] == i`,
    dead slots `context_lens == 0`) and run the C1-C3 decode kernels; the
    remaining rows run the §6.1 Q-Block prefill kernel."""
    nd = num_decode_seqs
    t = q.shape[0]
    if nd > t or nd > query_lens.shape[0]:
        raise ShardingError(
            f"paged_attention_unified: decode region ({nd} rows) exceeds "
            f"the packed batch (q shape {tuple(q.shape)}, "
            f"S={query_lens.shape[0]})")
    parts = []
    if nd:
        parts.append(paged_attention_decode(
            q[:nd], k_pages, v_pages, page_table[:nd], context_lens[:nd],
            variant=variant, tile=tile, num_segments=num_segments,
            scale=scale,
        ))
    if t > nd:
        parts.append(paged_attention_prefill(
            q[nd:], k_pages, v_pages, page_table[nd:], context_lens[nd:],
            query_start_loc[nd:] - nd, query_lens[nd:],
            block_q=block_q, tile=tile, num_q_blocks=num_q_blocks,
            scale=scale,
        ))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
