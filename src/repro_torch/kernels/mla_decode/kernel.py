"""MLA latent paged decode: the ctypes wrapper over `csrc/mla_decode.cu`,
its launch counters, and its plain PyTorch version.

`mla_decode` is the absorbed-form decode of deepseek-v2's MLA: q [S, H,
D] (D = r + rope: [q_nope . wk_b | q_rope]) over one page pool of
compressed rows k_pages [P, ps, D] ([latent | k_rope]), page_table [S, Np]
int32 and context_lens [S] int32, with V the first `v_dim` = r columns
of each K row.  Returns o_lat [S, H, v_dim] in q's dtype; a row at
context 0 is exact zeros.  It is the port of what the reference computes
with `decode_attention("xla", q_eff, k_pages, None, ..., v_dim=r)`
(`repro/core/attention/backend.py`), outside any Pallas kernel: no
Pallas kernel is replaced.

The keys of a sequence may be cut into `num_segments` segments of
`seg_keys` keys (split-KV: more blocks for a few sequences); the kernel
then writes fp32 partials and a second launch merges them.  Both counts
come from the shapes alone, so the launch captures into a CUDA graph.

A CUDA tensor launches the kernel on the current stream (or raises): the
tensor-core kernel in bf16 (D 576 / v_dim 512 only, 16-byte aligned
operands: another width raises `LaunchLimitError`), the scalar one in
fp32 (D <= 576, v_dim <= min(D, 512)).  A CPU tensor runs the plain
version.  Each wrapper call that launches adds one to
`LAUNCHES["mla_decode"]`, and each launched device kernel one to its
`KERNEL_LAUNCHES` entry (`mla_merge_kernel` only where segments merge).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (
    LaunchLimitError, _check_aligned, _finalize, _init_state, _on_card, _ptr,
    _raise_on, _stream, _tile_update,
)
from repro_torch.utils.misc import cdiv

NAME = "mla_decode"
_LIB_NAME = "mla_decode"
KV_TILE = 64  # keys a tile of the plain version and of the bf16 kernel
MMA_DIMS = (576, 512)  # (D, v_dim) of the bf16 tensor-core kernel
FP32_MAX_DIMS = (576, 512)
# keys of one segment are a multiple of this (the fp32 kernel's tile is
# 32 keys, the bf16 kernel's 64)
SEG_ALIGN = 64

LAUNCHES: dict[str, int] = {NAME: 0}
KERNEL_LAUNCHES: dict[str, int] = {"mla_mma_kernel": 0, "mla_fp32_kernel": 0,
                                   "mla_merge_kernel": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, KERNEL_LAUNCHES):
        for name in counts:
            counts[name] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int
_BOUND: dict[int, ctypes.CDLL] = {}


def library() -> ctypes.CDLL:
    """The kernel's shared library, built from csrc/ at first use."""
    lib = _build.load(_LIB_NAME)
    if id(lib) not in _BOUND:
        f = lib.mla_decode
        f.argtypes = [_P] * 7 + [_I] * 8 + [ctypes.c_float, _I, _P]
        f.restype = _I
        _BOUND[id(lib)] = lib
    return lib


def mla_decode_plain(q: torch.Tensor, k_pages: torch.Tensor,
                     page_table: torch.Tensor, context_lens: torch.Tensor, *,
                     v_dim: int, scale: float) -> torch.Tensor:
    """The kernel's function in PyTorch ops: the pages gathered per
    sequence, then an online softmax over tiles of KV_TILE keys, p
    rounded to V's dtype before p.V."""
    s_, h, _ = q.shape
    k = k_pages[page_table.long()]  # [S, Np, ps, D]
    k = k.reshape(s_, -1, k.shape[-1])
    ctx = context_lens.long()
    acc, m, l = _init_state((s_, h, v_dim), q.device)
    qf = q.float()
    for t0 in range(0, k.shape[1], KV_TILE):
        kt = k[:, t0:t0 + KV_TILE]
        pos = t0 + torch.arange(kt.shape[1], device=q.device)
        mask = (pos[None, :] < ctx[:, None])[:, None, :].expand(
            -1, h, -1)
        acc, m, l = _tile_update(qf, kt, kt[..., :v_dim], mask, scale, acc,
                                 m, l)
    return _finalize(acc, l, q.dtype)


def mla_decode(q: torch.Tensor, k_pages: torch.Tensor,
               page_table: torch.Tensor, context_lens: torch.Tensor, *,
               v_dim: int, scale: float, num_segments: int = 1,
               seg_keys: int | None = None) -> torch.Tensor:
    """q [S, H, D]; k_pages [P, ps, D]; page_table [S, Np] int32;
    context_lens [S] int32.  Keys [i * seg_keys, (i + 1) * seg_keys) form
    segment i (seg_keys: a multiple of SEG_ALIGN with num_segments *
    seg_keys >= Np * ps; default one segment).  Returns [S, H, v_dim]
    in q's dtype."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{NAME}: q must be float32 or bfloat16, got "
                        f"{q.dtype}")
    if k_pages.dtype != q.dtype:
        raise TypeError(f"{NAME}: k_pages {k_pages.dtype} must match q "
                        f"{q.dtype}")
    for t, what in ((page_table, "page_table"),
                    (context_lens, "context_lens")):
        if t.dtype != torch.int32:
            raise TypeError(f"{NAME}: {what} must be int32, got {t.dtype}")
    if q.ndim != 3 or k_pages.ndim != 3 or k_pages.shape[2] != q.shape[2]:
        raise ValueError(f"{NAME}: q {tuple(q.shape)} / k_pages "
                         f"{tuple(k_pages.shape)} must be [S, H, D] / "
                         f"[P, ps, D]")
    s_, h, d = q.shape
    if page_table.ndim != 2 or page_table.shape[0] != s_ \
            or context_lens.shape != (s_,):
        raise ValueError(f"{NAME}: page_table {tuple(page_table.shape)} / "
                         f"context_lens {tuple(context_lens.shape)} must be "
                         f"[S={s_}, Np] / [S]")
    if not 0 < v_dim <= d:
        raise ValueError(f"{NAME}: v_dim {v_dim} must be in (0, D={d}]")
    np_, ps = page_table.shape[1], k_pages.shape[1]
    keys = np_ * ps
    if seg_keys is None:
        seg_keys = cdiv(keys, SEG_ALIGN) * SEG_ALIGN
    if seg_keys % SEG_ALIGN or num_segments < 1 \
            or num_segments * seg_keys < keys:
        raise ValueError(f"{NAME}: {num_segments} segments of {seg_keys} "
                         f"keys must cover Np * ps = {keys} keys, seg_keys a "
                         f"multiple of {SEG_ALIGN}")
    if not _on_card(NAME, q, k_pages, page_table, context_lens):
        return mla_decode_plain(q, k_pages, page_table, context_lens,
                                v_dim=v_dim, scale=scale)
    for t in (q, k_pages, page_table, context_lens):
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: the CUDA kernel needs contiguous "
                             f"tensors (got strides {t.stride()})")
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        if (d, v_dim) != MMA_DIMS:
            raise LaunchLimitError(f"{NAME}: D / v_dim {d} / {v_dim} have no "
                                   f"bf16 tensor-core kernel ({MMA_DIMS})")
        _check_aligned(NAME, q, k_pages)
    elif d > FP32_MAX_DIMS[0] or v_dim > FP32_MAX_DIMS[1] or d % 8 \
            or v_dim % 8:
        raise LaunchLimitError(f"{NAME}: D / v_dim {d} / {v_dim} exceed the "
                               f"fp32 kernel's {FP32_MAX_DIMS} (multiples "
                               f"of 8)")
    out = torch.empty((s_, h, v_dim), dtype=q.dtype, device=q.device)
    part_o = part_ml = None
    if num_segments > 1:
        part_o = torch.empty((s_, h, num_segments, v_dim),
                             dtype=torch.float32, device=q.device)
        part_ml = torch.empty((s_, h, num_segments, 2), dtype=torch.float32,
                              device=q.device)
    with torch.cuda.device(q.device):
        rc = library().mla_decode(
            _ptr(q), _ptr(k_pages), _ptr(page_table), _ptr(context_lens),
            _ptr(out), None if part_o is None else _ptr(part_o),
            None if part_ml is None else _ptr(part_ml), s_, h, d, v_dim,
            np_, ps, num_segments, seg_keys, scale, int(bf16), _stream(q))
    _raise_on(rc, NAME)
    LAUNCHES[NAME] += 1
    KERNEL_LAUNCHES["mla_mma_kernel" if bf16 else "mla_fp32_kernel"] += 1
    if num_segments > 1:
        KERNEL_LAUNCHES["mla_merge_kernel"] += 1
    return out
