"""Paged-attention kernels: ctypes wrappers over `csrc/paged_attention.cu`,
their launch counters, and their plain PyTorch versions.

One wrapper per Pallas kernel of `repro/kernels/paged_attention/kernel.py`:

  paged_decode            C1 (baseline, cells = q heads, M = 1) and C2
                          (gqa, cells = KV heads, M = group) decode
  paged_decode_segmented  C3: per-segment unnormalised (acc, max, expsum)
  segment_reduce          C3 merge (paper Listing 5)
  paged_prefill_qblock    §6.1 Q-Block chunked prefill

and `paged_decode_segmented_merged`, the last two of C3 in one launch (the
serving path's C3 decode).  The wrappers take the Pallas kernels' inputs
(the KV cache in the tile view [Hkv, P, ps // tile, tile, D], Q pre-packed
by `ops.py`) and give the same outputs.  A CUDA tensor launches the
hand-written kernel on the current stream (or raises); a CPU tensor runs
the plain version below, which is what the CPU tests hold against the JAX
kernels.  Each launch of a CUDA kernel adds one to `LAUNCHES[name]` for
each Pallas function it computes (the merged launch counts both of C3's)
and one to `KERNEL_LAUNCHES` of the device kernel it ran, so a run can
show that its main path went through the kernels, and through which.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (
    NEG_INF, LaunchLimitError, _check_mma, _finalize, _init_state, _on_card,
    _ptr, _raise_on, _stream, _tile_update,
)
from repro_torch.utils.misc import cdiv

MAX_HEAD_DIM = 256
_LIB_NAME = "paged_attention"
_SMEM_LIMIT = 232448  # bytes of shared memory one block may opt in to (H100)

LAUNCHES: dict[str, int] = {"paged_decode": 0, "paged_decode_segmented": 0,
                            "segment_reduce": 0, "paged_prefill_qblock": 0}
# the same launches by CUDA kernel: the streaming decode kernel's three
# instantiations (whole context; segment partials; partials and merge),
# the standalone merge, and the prefill by dtype (bf16 tensor cores, fp32
# scalar)
KERNEL_LAUNCHES: dict[str, int] = {
    "decode_stream_kernel": 0, "decode_stream_seg_kernel": 0,
    "decode_stream_seg_merge_kernel": 0, "segment_reduce_kernel": 0,
    "prefill_mma_kernel": 0, "prefill_kernel": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, KERNEL_LAUNCHES):
        for name in counts:
            counts[name] = 0


# ---------------------------------------------------------------------------
# library binding
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "pa_attend_smem_bytes": ([_I, _I, _I], ctypes.c_size_t),
    "pa_paged_decode": ([_P] * 6 + [_I] * 5 + [_L] * 4 + [_I] * 3
                        + [_F, _I, _P], _I),
    "pa_paged_decode_segmented": ([_P] * 8 + [_I] * 6 + [_L] * 4 + [_I] * 3
                                  + [_F, _I, _P], _I),
    "pa_paged_decode_segmented_merged": ([_P] * 10 + [_L] + [_I] * 6
                                         + [_L] * 4 + [_I] * 3
                                         + [_F, _I, _P], _I),
    "pa_segment_reduce": ([_P] * 4 + [_I] * 6 + [_P], _I),
    "pa_paged_prefill_qblock": ([_P] * 8 + [_I] * 6 + [_L] * 4 + [_I] * 3
                                + [_F, _I, _P], _I),
}
_BOUND: dict[int, ctypes.CDLL] = {}
# the merged launch's arrival counters, one int32 buffer per (device,
# stream): zeroed when allocated, left zeroed by every launch.  A CUDA
# graph is captured on a stream of its own, so the graphs get their own
# buffer.  A buffer that a larger launch supersedes moves to _RETIRED and
# stays alive: a captured graph keeps reading it at its address.
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}
_RETIRED: list[torch.Tensor] = []


def library() -> ctypes.CDLL:
    """The kernels' shared library, built from csrc/ at first use."""
    lib = _build.load(_LIB_NAME)
    if id(lib) not in _BOUND:
        for fn, (args, res) in _SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes = args
            f.restype = res
        _BOUND[id(lib)] = lib
    return lib


def _check_common(name: str, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, ints: tuple[torch.Tensor, ...]) -> None:
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v dtypes differ "
                        f"({q.dtype}, {k.dtype}, {v.dtype})")
    if k.ndim != 5 or v.shape != k.shape:
        raise ValueError(f"{name}: k/v pages must share the tile view "
                         f"[Hkv, P, ps//tile, tile, D], got {tuple(k.shape)} "
                         f"and {tuple(v.shape)}")
    if k.shape[-1] != q.shape[-1]:
        raise ValueError(f"{name}: head_dim of q ({q.shape[-1]}) and k "
                         f"({k.shape[-1]}) differ")
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: metadata must be int32, got {t.dtype}")


def _check_table(name: str, page_table: torch.Tensor,
                 context_lens: torch.Tensor, rows: int | None) -> None:
    """page_table [S, Np] and context_lens [S]; `rows` = the S the other
    inputs imply (None: any)."""
    s_ = page_table.shape[0]
    if page_table.ndim != 2 or context_lens.shape != (s_,) \
            or (rows is not None and rows != s_):
        raise ValueError(f"{name}: page_table {tuple(page_table.shape)} / "
                         f"context_lens {tuple(context_lens.shape)} do not "
                         f"describe the {rows} sequences of q")


def _check_kernel(name: str, d: int, *tensors: torch.Tensor,
                  mma: bool = False, attend: tuple[int, int] | None = None,
                  vectors: tuple[torch.Tensor, ...] = ()) -> None:
    """Contiguity, then (mma) what the bf16 tensor-core prefill takes, or
    the head dim of the other kernels (multiples of 8 up to MAX_HEAD_DIM).
    `vectors`: tensors the kernel reads in 16-byte loads (the streaming
    decode's K and V pages), which must be 16-byte aligned.  `attend` =
    (rows, tile) of a block of the scalar fp32 prefill, whose shared
    memory grows with both; the streaming decode needs at most 41.2 KB a
    block at any head dim it takes, so its shape has no other limit."""
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel needs contiguous "
                             f"tensors (got strides {t.stride()})")
    if mma:
        _check_mma(name, d, *tensors[:3])
        return
    if d > MAX_HEAD_DIM or d % 8:
        raise LaunchLimitError(f"{name}: head_dim {d} unsupported by the "
                               f"CUDA kernel (multiples of 8 up to "
                               f"{MAX_HEAD_DIM})")
    for t in vectors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the CUDA kernel reads K/V in 16-byte "
                             f"vectors and needs them 16-byte aligned "
                             f"(data_ptr {t.data_ptr():#x})")
    if attend is not None:
        m, tile = attend
        smem = library().pa_attend_smem_bytes(m, d, tile)
        if smem > _SMEM_LIMIT:
            raise LaunchLimitError(
                f"{name}: {m} rows x head_dim {d} x tile {tile} needs "
                f"{smem} B of shared memory per block (limit "
                f"{_SMEM_LIMIT})")


def _check_segmented(name: str, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, page_table: torch.Tensor,
                     context_lens: torch.Tensor, num_segments: int,
                     tiles_per_segment: int) -> None:
    _check_common(name, q, k, v, (page_table, context_lens))
    if q.ndim != 4 or q.shape[1] != k.shape[0]:
        raise ValueError(f"{name}: q {tuple(q.shape)} must be "
                         f"[S, Hkv={k.shape[0]}, M, D]")
    _check_table(name, page_table, context_lens, q.shape[0])
    if num_segments < 1 or tiles_per_segment < 1:
        raise ValueError(f"{name}: need num_segments, tiles_per_segment "
                         f">= 1, got {num_segments}, {tiles_per_segment}")


def _merge_counters(device: torch.device, stream: int,
                    n: int) -> torch.Tensor:
    """At least n zeroed counters for the merged launch on `stream`; no
    two streams share one.  The buffer keeps its address until a launch
    needs more; the one it replaces is kept alive (`_RETIRED`), zeroed as
    every launch leaves it, so a graph that captured it replays on it."""
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _RETIRED.append(buf)
        buf = _COUNTERS[key] = torch.zeros(n, dtype=torch.int32,
                                           device=device)
    return buf


def _kv_strides(k: torch.Tensor, v: torch.Tensor) -> tuple[int, ...]:
    """(k head, k page, v head, v page) strides in elements."""
    return k.stride(0), k.stride(1), v.stride(0), v.stride(1)


# ---------------------------------------------------------------------------
# plain PyTorch versions (same masking constants and output contract)
# ---------------------------------------------------------------------------


def _live_tiles(context_lens: torch.Tensor, tile: int, num_tiles: int) -> int:
    if context_lens.numel() == 0:
        return 0
    return min(cdiv(max(int(context_lens.max()), 0), tile), num_tiles)


def paged_decode_plain(q, k_pages, v_pages, page_table, context_lens, *,
                       cells_per_kv: int, scale: float) -> torch.Tensor:
    s_, n_cells, m, d = q.shape
    hkv, _, tpp, tile, _ = k_pages.shape
    num_tiles = page_table.shape[1] * tpp
    kvh = torch.arange(n_cells, device=q.device) // cells_per_kv
    qf = q.float()
    acc, mm, ll = _init_state(q.shape, q.device)
    ctx = context_lens.long()
    for t in range(_live_tiles(context_lens, tile, num_tiles)):
        page = page_table[:, t // tpp].long()
        k = k_pages[kvh[None, :], page[:, None], t % tpp]  # [S, C, tile, D]
        v = v_pages[kvh[None, :], page[:, None], t % tpp]
        pos = t * tile + torch.arange(tile, device=q.device)
        mask = (pos[None, :] < ctx[:, None])[:, None, None, :]
        mask = mask.expand(s_, n_cells, m, tile)
        acc, mm, ll = _tile_update(qf, k, v, mask, scale, acc, mm, ll)
    return _finalize(acc, ll, q.dtype)


def paged_decode_segmented_plain(q, k_pages, v_pages, page_table,
                                 context_lens, *, num_segments: int,
                                 tiles_per_segment: int, scale: float):
    s_, hkv, m, d = q.shape
    _, _, tpp, tile, _ = k_pages.shape
    np_ = page_table.shape[1]
    num_tiles = np_ * tpp
    nseg, tps = num_segments, tiles_per_segment
    dev = q.device
    qf = q.float()[:, :, None].expand(s_, hkv, nseg, m, d)
    acc, mm, ll = _init_state((s_, hkv, nseg, m, d), dev)
    ctx = context_lens.long()
    heads = torch.arange(hkv, device=dev)
    segs = torch.arange(nseg, device=dev)
    for t in range(min(tps, _live_tiles(context_lens, tile, num_tiles))):
        tile_idx = segs * tps + t  # [nseg]
        col = torch.clamp(tile_idx // tpp, max=np_ - 1)
        page = page_table[:, col].long()  # [S, nseg]
        sub = tile_idx % tpp
        k = k_pages[heads[None, :, None], page[:, None, :], sub]  # [S,H,G,t,D]
        v = v_pages[heads[None, :, None], page[:, None, :], sub]
        pos = tile_idx[:, None] * tile + torch.arange(tile, device=dev)
        mask = (pos[None] < ctx[:, None, None]) \
            & (tile_idx < num_tiles)[None, :, None]  # [S, nseg, tile]
        mask = mask[:, None, :, None, :].expand(s_, hkv, nseg, m, tile)
        acc, mm, ll = _tile_update(qf, k, v, mask, scale, acc, mm, ll)
    return acc, mm, ll


def segment_reduce_plain(o_seg, m_seg, l_seg, out_dtype) -> torch.Tensor:
    m_star = m_seg.amax(2, keepdim=True)  # [S, H, 1, M]
    m_safe = torch.where(m_star > NEG_INF / 2, m_star, 0.0)
    w = torch.exp(m_seg - m_safe) * (m_seg > NEG_INF / 2)
    l_tot = (l_seg * w).sum(2)
    o_tot = (o_seg * w[..., None]).sum(2)
    l_safe = torch.where(l_tot == 0.0, 1.0, l_tot)
    return (o_tot / l_safe[..., None]).to(out_dtype)


def paged_decode_segmented_merged_plain(q, k_pages, v_pages, page_table,
                                        context_lens, *, num_segments: int,
                                        tiles_per_segment: int,
                                        scale: float) -> torch.Tensor:
    return segment_reduce_plain(*paged_decode_segmented_plain(
        q, k_pages, v_pages, page_table, context_lens,
        num_segments=num_segments, tiles_per_segment=tiles_per_segment,
        scale=scale), q.dtype)


def paged_prefill_qblock_plain(q_packed, k_pages, v_pages, qb_seq, qb_pos0,
                               page_table, context_lens, *, block_q: int,
                               group: int, scale: float) -> torch.Tensor:
    nqb, hkv, bm, d = q_packed.shape
    _, _, tpp, tile, _ = k_pages.shape
    num_tiles = page_table.shape[1] * tpp
    dev = q_packed.device
    valid = qb_seq >= 0
    seq_c = torch.clamp(qb_seq, min=0).long()
    pos0 = qb_pos0.long()
    ctx = context_lens.long()[seq_c]
    last_pos = torch.minimum(pos0 + block_q - 1, ctx - 1)
    q_pos = pos0[:, None] + torch.arange(bm, device=dev) // group  # [NQB, BM]
    heads = torch.arange(hkv, device=dev)
    live = torch.where(valid, last_pos, -1)
    n_t = 0 if nqb == 0 else min(max(int(live.max()), -1) // tile + 1,
                                 num_tiles)
    qf = q_packed.float()
    acc, mm, ll = _init_state(q_packed.shape, dev)
    for t in range(n_t):
        page = page_table[seq_c, t // tpp].long()  # [NQB]
        k = k_pages[heads[None, :], page[:, None], t % tpp]  # [NQB,H,tile,D]
        v = v_pages[heads[None, :], page[:, None], t % tpp]
        pos = t * tile + torch.arange(tile, device=dev)
        blk = (valid & (t * tile <= last_pos))[:, None, None]
        mask = blk & (pos[None, None, :] < ctx[:, None, None]) \
            & (pos[None, None, :] <= q_pos[:, :, None])  # [NQB, BM, tile]
        mask = mask[:, None].expand(nqb, hkv, bm, tile)
        acc, mm, ll = _tile_update(qf, k, v, mask, scale, acc, mm, ll)
    return _finalize(acc, ll, q_packed.dtype)


# ---------------------------------------------------------------------------
# wrappers: CUDA tensor -> kernel, CPU tensor -> plain version
# ---------------------------------------------------------------------------


def paged_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, page_table: torch.Tensor,
                 context_lens: torch.Tensor, *, cells_per_kv: int,
                 scale: float) -> torch.Tensor:
    """C1/C2 decode.  q [S, n_cells, M, D]; k/v tile view
    [Hkv, P, ps//tile, tile, D]; page_table [S, Np] i32; context_lens [S]
    i32.  Cell c reads KV head c // cells_per_kv (1 for gqa, group for
    baseline).  Returns [S, n_cells, M, D] in q's dtype; rows with
    context 0 are exact zeros.  On the card one launch of the streaming
    decode kernel (a KV head's cells are one block's rows; `tile` is
    validated only, the kernel groups keys its own way)."""
    name = "paged_decode"
    _check_common(name, q, k_pages, v_pages, (page_table, context_lens))
    if q.ndim != 4 or q.shape[1] != k_pages.shape[0] * cells_per_kv:
        raise ValueError(f"{name}: q {tuple(q.shape)} must be [S, Hkv * "
                         f"cells_per_kv = {k_pages.shape[0] * cells_per_kv}"
                         f", M, D]")
    _check_table(name, page_table, context_lens, q.shape[0])
    if not _on_card(name, q, k_pages, v_pages, page_table, context_lens):
        return paged_decode_plain(q, k_pages, v_pages, page_table,
                                  context_lens, cells_per_kv=cells_per_kv,
                                  scale=scale)
    s_, n_cells, m, d = q.shape
    _, _, tpp, tile, _ = k_pages.shape
    _check_kernel(name, d, q, k_pages, v_pages, page_table, context_lens,
                  vectors=(k_pages, v_pages))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = library().pa_paged_decode(
            _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(page_table),
            _ptr(context_lens), _ptr(out), s_, n_cells, m, d, cells_per_kv,
            *_kv_strides(k_pages, v_pages), tpp * tile, tile,
            page_table.shape[1], scale, int(q.dtype == torch.bfloat16),
            _stream(q))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    KERNEL_LAUNCHES["decode_stream_kernel"] += 1
    return out


def paged_decode_segmented(q, k_pages, v_pages, page_table, context_lens, *,
                           num_segments: int, tiles_per_segment: int,
                           scale: float):
    """C3 decode partials.  q [S, Hkv, M, D].  Returns (o_seg
    [S, Hkv, nseg, M, D] f32 unnormalised, m_seg [S, Hkv, nseg, M] f32,
    l_seg [S, Hkv, nseg, M] f32); segment g covers the keys
    [g * tps * tile, min((g + 1) * tps * tile, ctx)), and one without a
    live key is exactly (0, NEG_INF, 0).  The serving path takes
    `paged_decode_segmented_merged` instead."""
    name = "paged_decode_segmented"
    _check_segmented(name, q, k_pages, v_pages, page_table, context_lens,
                     num_segments, tiles_per_segment)
    if not _on_card(name, q, k_pages, v_pages, page_table, context_lens):
        return paged_decode_segmented_plain(
            q, k_pages, v_pages, page_table, context_lens,
            num_segments=num_segments, tiles_per_segment=tiles_per_segment,
            scale=scale)
    s_, hkv, m, d = q.shape
    _, _, tpp, tile, _ = k_pages.shape
    _check_kernel(name, d, q, k_pages, v_pages, page_table, context_lens,
                  vectors=(k_pages, v_pages))
    f32 = dict(dtype=torch.float32, device=q.device)
    o_seg = torch.empty((s_, hkv, num_segments, m, d), **f32)
    m_seg = torch.empty((s_, hkv, num_segments, m), **f32)
    l_seg = torch.empty((s_, hkv, num_segments, m), **f32)
    with torch.cuda.device(q.device):
        rc = library().pa_paged_decode_segmented(
            _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(page_table),
            _ptr(context_lens), _ptr(o_seg), _ptr(m_seg), _ptr(l_seg),
            s_, hkv, num_segments, tiles_per_segment, m, d,
            *_kv_strides(k_pages, v_pages), tpp * tile, tile,
            page_table.shape[1], scale, int(q.dtype == torch.bfloat16),
            _stream(q))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    KERNEL_LAUNCHES["decode_stream_seg_kernel"] += 1
    return o_seg, m_seg, l_seg


def paged_decode_segmented_merged(q, k_pages, v_pages, page_table,
                                  context_lens, *, num_segments: int,
                                  tiles_per_segment: int,
                                  scale: float) -> torch.Tensor:
    """C3 decode in one launch: `segment_reduce` of the partials of
    `paged_decode_segmented` (same inputs) -> [S, Hkv, M, D] in q's dtype;
    rows with context 0 are exact zeros.  On the card the last segment
    block of each (sequence, KV head, row group) to finish merges the
    segments, with the standalone merge's arithmetic (the same bits on the
    same partials); the partials are workspace."""
    name = "paged_decode_segmented_merged"
    _check_segmented(name, q, k_pages, v_pages, page_table, context_lens,
                     num_segments, tiles_per_segment)
    if not _on_card(name, q, k_pages, v_pages, page_table, context_lens):
        return paged_decode_segmented_merged_plain(
            q, k_pages, v_pages, page_table, context_lens,
            num_segments=num_segments, tiles_per_segment=tiles_per_segment,
            scale=scale)
    s_, hkv, m, d = q.shape
    _, _, tpp, tile, _ = k_pages.shape
    _check_kernel(name, d, q, k_pages, v_pages, page_table, context_lens,
                  vectors=(k_pages, v_pages))
    rows = s_ * hkv * num_segments * m  # partial rows: o_seg | m_seg | l_seg
    ws = torch.empty(rows * (d + 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    stream = _stream(q)
    counters = _merge_counters(q.device, stream, s_ * hkv * m)
    o_seg = _ptr(ws)
    with torch.cuda.device(q.device):
        rc = library().pa_paged_decode_segmented_merged(
            _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(page_table),
            _ptr(context_lens), o_seg, o_seg + 4 * rows * d,
            o_seg + 4 * rows * (d + 1), _ptr(out), _ptr(counters),
            counters.numel(), s_, hkv, num_segments, tiles_per_segment, m, d,
            *_kv_strides(k_pages, v_pages), tpp * tile, tile,
            page_table.shape[1], scale, int(q.dtype == torch.bfloat16),
            stream)
    _raise_on(rc, name)
    LAUNCHES["paged_decode_segmented"] += 1
    LAUNCHES["segment_reduce"] += 1
    KERNEL_LAUNCHES["decode_stream_seg_merge_kernel"] += 1
    return out


def segment_reduce(o_seg: torch.Tensor, m_seg: torch.Tensor,
                   l_seg: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Merge C3 partials -> [S, Hkv, M, D] in `out_dtype`; all-dead rows are
    exact zeros.  The serving path merges inside the segmented launch
    (`paged_decode_segmented_merged`)."""
    name = "segment_reduce"
    for t in (o_seg, m_seg, l_seg):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: segment partials must be float32")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: unsupported out dtype {out_dtype}")
    if o_seg.ndim != 5 or m_seg.shape != o_seg.shape[:4] \
            or l_seg.shape != m_seg.shape:
        raise ValueError(f"{name}: shapes {tuple(o_seg.shape)}, "
                         f"{tuple(m_seg.shape)}, {tuple(l_seg.shape)}")
    if not _on_card(name, o_seg, m_seg, l_seg):
        return segment_reduce_plain(o_seg, m_seg, l_seg, out_dtype)
    s_, hkv, nseg, m, d = o_seg.shape
    _check_kernel(name, d, o_seg, m_seg, l_seg)
    out = torch.empty((s_, hkv, m, d), dtype=out_dtype, device=o_seg.device)
    with torch.cuda.device(o_seg.device):
        rc = library().pa_segment_reduce(
            _ptr(o_seg), _ptr(m_seg), _ptr(l_seg), _ptr(out), s_, hkv, nseg,
            m, d, int(out_dtype == torch.bfloat16), _stream(o_seg))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    KERNEL_LAUNCHES["segment_reduce_kernel"] += 1
    return out


def paged_prefill_qblock(q_packed, k_pages, v_pages, qb_seq, qb_pos0,
                         page_table, context_lens, *, block_q: int,
                         group: int, scale: float) -> torch.Tensor:
    """§6.1 Q-Block prefill.  q_packed [NQB, Hkv, block_q*group, D] (row =
    tok * group + g); qb_seq / qb_pos0 [NQB] i32 (seq -1 = dead block).
    Returns q_packed's shape and dtype; dead blocks are exact zeros.  On
    the card bf16 runs the tensor-core kernel (head dim 64 or 128, any
    block_q * group, its own 64-key tile; `tile` is still validated) and
    fp32 the scalar one."""
    name = "paged_prefill_qblock"
    _check_common(name, q_packed, k_pages, v_pages,
                  (qb_seq, qb_pos0, page_table, context_lens))
    if q_packed.ndim != 4 or q_packed.shape[2] != block_q * group \
            or q_packed.shape[1] != k_pages.shape[0]:
        raise ValueError(f"{name}: q_packed {tuple(q_packed.shape)} must be "
                         f"[NQB, Hkv={k_pages.shape[0]}, block_q*group="
                         f"{block_q * group}, D]")
    if qb_seq.shape != (q_packed.shape[0],) or qb_pos0.shape != qb_seq.shape:
        raise ValueError(f"{name}: qb_seq / qb_pos0 must be [NQB="
                         f"{q_packed.shape[0]}]")
    _check_table(name, page_table, context_lens, None)
    if not _on_card(name, q_packed, k_pages, v_pages, qb_seq, qb_pos0,
                    page_table, context_lens):
        return paged_prefill_qblock_plain(
            q_packed, k_pages, v_pages, qb_seq, qb_pos0, page_table,
            context_lens, block_q=block_q, group=group, scale=scale)
    nqb, hkv, bm, d = q_packed.shape
    _, _, tpp, tile, _ = k_pages.shape
    bf16 = q_packed.dtype == torch.bfloat16
    _check_kernel(name, d, q_packed, k_pages, v_pages, qb_seq, qb_pos0,
                  page_table, context_lens, mma=bf16,
                  attend=None if bf16 else (bm, tile))
    out = torch.empty_like(q_packed)
    with torch.cuda.device(q_packed.device):
        rc = library().pa_paged_prefill_qblock(
            _ptr(q_packed), _ptr(k_pages), _ptr(v_pages), _ptr(qb_seq),
            _ptr(qb_pos0), _ptr(page_table), _ptr(context_lens), _ptr(out),
            nqb, hkv, bm, d, block_q, group, *_kv_strides(k_pages, v_pages),
            tpp * tile, tile, page_table.shape[1], scale,
            int(bf16), _stream(q_packed))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    KERNEL_LAUNCHES["prefill_mma_kernel" if bf16 else "prefill_kernel"] += 1
    return out
