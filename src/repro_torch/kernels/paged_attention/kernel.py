"""Paged-attention kernels: ctypes wrappers over `csrc/paged_attention.cu`,
their launch counters, and their plain PyTorch versions.

One wrapper per Pallas kernel of `repro/kernels/paged_attention/kernel.py`:

  paged_decode            C1 (baseline, cells = q heads, M = 1) and C2
                          (gqa, cells = KV heads, M = group) decode
  paged_decode_segmented  C3: per-segment unnormalised (acc, max, expsum)
  segment_reduce          C3 merge (paper Listing 5)
  paged_prefill_qblock    §6.1 Q-Block chunked prefill

The wrappers take the Pallas kernels' inputs (the KV cache in the tile
view [Hkv, P, ps // tile, tile, D], Q pre-packed by `ops.py`) and give the
same outputs.  A CUDA tensor launches the hand-written kernel on the
current stream (or raises); a CPU tensor runs the plain version below,
which is what the CPU tests hold against the JAX kernels.  Each launch of
a CUDA kernel adds one to `LAUNCHES[name]`, so a run can show that its
main path went through the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.utils.misc import cdiv

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
MAX_HEAD_DIM = 256
_LIB_NAME = "paged_attention"
_SMEM_LIMIT = 232448  # bytes of shared memory one block may opt in to (H100)

LAUNCHES: dict[str, int] = {"paged_decode": 0, "paged_decode_segmented": 0,
                            "segment_reduce": 0, "paged_prefill_qblock": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    "pa_segment_reduce": ([_P] * 4 + [_I] * 6 + [_P], _I),
    "pa_paged_prefill_qblock": ([_P] * 8 + [_I] * 6 + [_L] * 4 + [_I] * 3
                                + [_F, _I, _P], _I),
}
_BOUND: dict[int, ctypes.CDLL] = {}


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


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError_t {rc}")


def _on_card(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (run the plain version); raises on mixed or other devices."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one device, "
                             f"got {t.device} and {dev}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {dev}")


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


def _check_kernel(name: str, d: int, m: int, tile: int,
                  *tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel needs contiguous "
                             f"tensors (got strides {t.stride()})")
    if d > MAX_HEAD_DIM or d % 8:
        raise ValueError(f"{name}: head_dim {d} unsupported by the CUDA "
                         f"kernel (multiples of 8 up to {MAX_HEAD_DIM})")
    smem = library().pa_attend_smem_bytes(m, d, tile)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{name}: {m} rows x head_dim {d} x tile {tile} "
                         f"needs {smem} B of shared memory per block "
                         f"(limit {_SMEM_LIMIT})")


def _kv_strides(k: torch.Tensor, v: torch.Tensor) -> tuple[int, ...]:
    """(k head, k page, v head, v page) strides in elements."""
    return k.stride(0), k.stride(1), v.stride(0), v.stride(1)


# ---------------------------------------------------------------------------
# plain PyTorch versions (same masking constants and output contract)
# ---------------------------------------------------------------------------


def _tile_update(q, k, v, mask, scale, acc, m, l):
    """One online-softmax tile step, `_flash_tile_update` of the Pallas
    kernel.  q [..., M, D] f32; k/v [..., tile, D]; mask [..., M, tile].
    A fully masked step leaves (acc, m, l) exactly unchanged, so visiting
    a tile the kernel skips changes nothing."""
    s = torch.einsum("...md,...td->...mt", q, k.float()) * scale
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    m_safe = torch.where(m_new <= NEG_INF, 0.0, m_new)
    p = torch.exp(torch.where(mask, s - m_safe[..., None], NEG_INF))
    alpha = torch.exp(torch.clamp(m - m_safe, max=0.0))
    alpha = torch.where(m <= NEG_INF, 0.0, alpha)
    l_new = l * alpha + p.sum(-1)
    pv = torch.einsum("...mt,...td->...md", p.to(v.dtype).float(), v.float())
    return acc * alpha[..., None] + pv, m_new, l_new


def _init_state(shape, device):
    *lead, d = shape
    return (torch.zeros(shape, dtype=torch.float32, device=device),
            torch.full(lead, NEG_INF, dtype=torch.float32, device=device),
            torch.zeros(lead, dtype=torch.float32, device=device))


def _finalize(acc, l, dtype):
    l_safe = torch.where(l == 0.0, 1.0, l)
    return (acc / l_safe[..., None]).to(dtype)


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
    context 0 are exact zeros."""
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
    _check_kernel(name, d, m, tile, q, k_pages, v_pages, page_table,
                  context_lens)
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
    return out


def paged_decode_segmented(q, k_pages, v_pages, page_table, context_lens, *,
                           num_segments: int, tiles_per_segment: int,
                           scale: float):
    """C3 decode partials.  q [S, Hkv, M, D].  Returns (o_seg
    [S, Hkv, nseg, M, D] f32 unnormalised, m_seg [S, Hkv, nseg, M] f32,
    l_seg [S, Hkv, nseg, M] f32)."""
    name = "paged_decode_segmented"
    _check_common(name, q, k_pages, v_pages, (page_table, context_lens))
    if q.ndim != 4 or q.shape[1] != k_pages.shape[0]:
        raise ValueError(f"{name}: q {tuple(q.shape)} must be "
                         f"[S, Hkv={k_pages.shape[0]}, M, D]")
    _check_table(name, page_table, context_lens, q.shape[0])
    if num_segments < 1 or tiles_per_segment < 1:
        raise ValueError(f"{name}: need num_segments, tiles_per_segment "
                         f">= 1, got {num_segments}, {tiles_per_segment}")
    if not _on_card(name, q, k_pages, v_pages, page_table, context_lens):
        return paged_decode_segmented_plain(
            q, k_pages, v_pages, page_table, context_lens,
            num_segments=num_segments, tiles_per_segment=tiles_per_segment,
            scale=scale)
    s_, hkv, m, d = q.shape
    _, _, tpp, tile, _ = k_pages.shape
    _check_kernel(name, d, m, tile, q, k_pages, v_pages, page_table,
                  context_lens)
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
    return o_seg, m_seg, l_seg


def segment_reduce(o_seg: torch.Tensor, m_seg: torch.Tensor,
                   l_seg: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Merge C3 partials -> [S, Hkv, M, D] in `out_dtype`; all-dead rows are
    exact zeros."""
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
    _check_kernel(name, d, 1, 8, o_seg, m_seg, l_seg)
    out = torch.empty((s_, hkv, m, d), dtype=out_dtype, device=o_seg.device)
    with torch.cuda.device(o_seg.device):
        rc = library().pa_segment_reduce(
            _ptr(o_seg), _ptr(m_seg), _ptr(l_seg), _ptr(out), s_, hkv, nseg,
            m, d, int(out_dtype == torch.bfloat16), _stream(o_seg))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


def paged_prefill_qblock(q_packed, k_pages, v_pages, qb_seq, qb_pos0,
                         page_table, context_lens, *, block_q: int,
                         group: int, scale: float) -> torch.Tensor:
    """§6.1 Q-Block prefill.  q_packed [NQB, Hkv, block_q*group, D] (row =
    tok * group + g); qb_seq / qb_pos0 [NQB] i32 (seq -1 = dead block).
    Returns q_packed's shape and dtype; dead blocks are exact zeros."""
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
    _check_kernel(name, d, bm, tile, q_packed, k_pages, v_pages, qb_seq,
                  qb_pos0, page_table, context_lens)
    out = torch.empty_like(q_packed)
    with torch.cuda.device(q_packed.device):
        rc = library().pa_paged_prefill_qblock(
            _ptr(q_packed), _ptr(k_pages), _ptr(v_pages), _ptr(qb_seq),
            _ptr(qb_pos0), _ptr(page_table), _ptr(context_lens), _ptr(out),
            nqb, hkv, bm, d, block_q, group, *_kv_strides(k_pages, v_pages),
            tpp * tile, tile, page_table.shape[1], scale,
            int(q_packed.dtype == torch.bfloat16), _stream(q_packed))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out
