"""Flash-attention forward: the ctypes wrapper over
`csrc/flash_attention.cu`, its launch counter, and its plain PyTorch
version.

`flash_attention_fwd` is the port of the Pallas kernel
`repro/kernels/flash_attention/kernel.py:flash_attention_fwd`, with the
same packed inputs (q [B*Hkv, nq, block_q * group, Dk], row = tok * group
+ g; k [B*Hkv, Skv, Dk], v [B*Hkv, Skv, Dv]).  It also returns the fp32
row logsumexp the backward needs.  The value width may differ from the
key width (MLA's expanded prefill: Dk 192, Dv 128), and an optional
`kv_len` [B*Hkv] masks the keys at or past each slice's length, as
`flash_attention_xla(kv_len=)` does.  KV is walked in tiles of `KV_TILE` keys; since p is
rounded to V's dtype under the running max of its tile, the plain
version uses the same tile, so in bf16 the two agree to the rounding of
the output.  A CUDA tensor launches the kernel on the current stream (or
raises): the tensor-core kernel in bf16 (Dk = Dv = 64 or 128, or Dk 192
/ Dv 128; other widths raise), the scalar fp32 kernel in fp32.  A CPU tensor runs the
plain version.  Each kernel launch adds
one to `LAUNCHES["flash_attention_fwd"]` and one to its device kernel's
`KERNEL_LAUNCHES` entry (`flash_mma_kernel` in bf16, `flash_fwd_kernel`
in fp32).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (
    NEG_INF, LaunchLimitError, _check_aligned, _check_mma, _finalize,
    _init_state, _plain, _ptr, _raise_on, _record, _route, _stream,
    _tile_update,
)
from repro_torch.roofline import analysis
from repro_torch.utils.misc import cdiv

MAX_ROWS = 64  # block_q * group rows of one thread block
KV_TILE = 64   # keys per KV tile
MAX_HEAD_DIM = 256
# the (Dk, Dv) pairs of the bf16 tensor-core kernel whose widths differ:
# MLA's expanded prefill (qk_nope 128 + rope 64 against v 128)
MMA_SPLIT_DIMS = ((192, 128),)
_LIB_NAME = "flash_attention"

LAUNCHES: dict[str, int] = {"flash_attention_fwd": 0}
KERNEL_LAUNCHES: dict[str, int] = {"flash_mma_kernel": 0,
                                   "flash_fwd_kernel": 0}


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
        f = lib.fa_flash_attention_fwd
        f.argtypes = [_P] * 6 + [_I] * 8 + [ctypes.c_float, _I, _I, _I, _P]
        f.restype = _I
        _BOUND[id(lib)] = lib
    return lib


def flash_attention_fwd_plain(q, k, v, *, block_q: int, group: int,
                              scale: float, causal: bool, q_offset: int,
                              kv_len=None):
    """The kernel's function in PyTorch ops: online softmax over KV tiles
    of KV_TILE keys.  Returns (o [BH, nq, BM, Dv] in q's dtype, lse [BH,
    nq, BM] f32)."""
    bh, nq, bm, _ = q.shape
    skv = k.shape[1]
    dev = q.device
    q_pos = (q_offset + torch.arange(nq, device=dev)[:, None] * block_q
             + torch.arange(bm, device=dev)[None, :] // group)  # [nq, BM]
    n_t = cdiv(skv, KV_TILE)
    if causal:
        n_t = min(n_t, cdiv(q_offset + nq * block_q, KV_TILE))
    qf = q.float()
    acc, m, l = _init_state((bh, nq, bm, v.shape[2]), dev)
    for t in range(n_t):
        kt = k[:, None, t * KV_TILE:(t + 1) * KV_TILE]  # [BH, 1, tile, Dk]
        vt = v[:, None, t * KV_TILE:(t + 1) * KV_TILE]
        kv_pos = t * KV_TILE + torch.arange(kt.shape[2], device=dev)
        mask = (kv_pos[None, None, :] <= q_pos[:, :, None]) if causal else \
            torch.ones((nq, bm, kv_pos.numel()), dtype=torch.bool, device=dev)
        mask = mask.expand(bh, -1, -1, -1)
        if kv_len is not None:
            mask = mask & (kv_pos < kv_len[:, None])[:, None, None, :]
        acc, m, l = _tile_update(qf, kt, vt, mask, scale, acc, m, l)
    lse = torch.where(l == 0.0, NEG_INF,
                      m + torch.log(torch.where(l == 0.0, 1.0, l)))
    return _finalize(acc, l, q.dtype), lse


def _check_widths(name: str, dk: int, dv: int, *tensors) -> None:
    """The bf16 tensor-core kernel's widths: Dk = Dv in MMA_HEAD_DIMS, or
    a pair of MMA_SPLIT_DIMS; 16-byte aligned operands."""
    if dk == dv:
        _check_mma(name, dk, *tensors)
        return
    if (dk, dv) not in MMA_SPLIT_DIMS:
        raise LaunchLimitError(f"{name}: key / value widths {dk} / {dv} "
                               f"have no bf16 tensor-core kernel (pairs "
                               f"{MMA_SPLIT_DIMS})")
    _check_aligned(name, *tensors)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, block_q: int, group: int, scale: float,
                        causal: bool, q_offset: int,
                        kv_len: torch.Tensor | None = None):
    """Dense (causal) GQA flash-attention forward.  q [BH, nq, block_q *
    group, Dk] packed with row = tok * group + g; k [BH, Skv, Dk]; v [BH,
    Skv, Dv]; the query token at row r of block qi sits at q_offset + qi *
    block_q + r // group.  kv_len [BH] int32 (optional): keys >= kv_len[bh]
    are masked for every row of slice bh.  Returns (o [BH, nq, block_q *
    group, Dv] in q's dtype, lse [BH, nq, block_q * group] f32, -0.7 * f32
    max where a row saw no live key)."""
    name = "flash_attention_fwd"
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v dtypes differ "
                        f"({q.dtype}, {k.dtype}, {v.dtype})")
    if q.ndim != 4 or q.shape[2] != block_q * group:
        raise ValueError(f"{name}: q {tuple(q.shape)} must be [BH, nq, "
                         f"block_q*group={block_q * group}, D]")
    if k.ndim != 3 or v.ndim != 3 or v.shape[:2] != k.shape[:2] \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[3]:
        raise ValueError(f"{name}: k/v {tuple(k.shape)}, {tuple(v.shape)} "
                         f"must be [BH={q.shape[0]}, Skv, Dk={q.shape[3]}] "
                         f"and [BH, Skv, Dv]")
    if kv_len is not None and (kv_len.shape != (q.shape[0],)
                               or kv_len.dtype != torch.int32):
        raise ValueError(f"{name}: kv_len {tuple(kv_len.shape)} "
                         f"{kv_len.dtype} must be int32 [BH={q.shape[0]}]")
    if q_offset < 0:
        raise ValueError(f"{name}: q_offset must be >= 0, got {q_offset}")
    tensors = (q, k, v) if kv_len is None else (q, k, v, kv_len)
    route = _route(name, *tensors)
    bh, nq, bm, d = q.shape
    dv = v.shape[2]
    # from the shapes: every key below kv_len's bound (Skv) live
    _record(name, analysis.flash_work, b=bh, sq=nq * block_q,
            skv=k.shape[1], hq=group, hkv=1, dk=d, dv=dv, causal=causal,
            e=q.element_size(), q_offset=q_offset)
    if route == "meta":
        return (torch.empty((bh, nq, bm, dv), dtype=q.dtype, device=q.device),
                torch.empty((bh, nq, bm), dtype=torch.float32,
                            device=q.device))
    if route == "cpu":
        return _plain(flash_attention_fwd_plain, q, k, v, block_q=block_q,
                      group=group, scale=scale, causal=causal,
                      q_offset=q_offset, kv_len=kv_len)
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel needs contiguous "
                             f"tensors (got strides {t.stride()})")
    if max(d, dv) > MAX_HEAD_DIM or d % 8 or dv % 8:
        raise ValueError(f"{name}: head_dim {d} (value width {dv}) "
                         f"unsupported by the CUDA kernel (multiples of 8 "
                         f"up to {MAX_HEAD_DIM})")
    if q.dtype == torch.bfloat16:
        _check_widths(name, d, dv, q, k, v)
    if bm > MAX_ROWS:
        raise ValueError(f"{name}: block_q * group = {bm} rows exceeds the "
                         f"kernel's {MAX_ROWS}")
    o = torch.empty((bh, nq, bm, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((bh, nq, bm), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = library().fa_flash_attention_fwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(lse),
            None if kv_len is None else _ptr(kv_len), bh, nq, bm, d, dv,
            k.shape[1], block_q, group, scale, int(causal), q_offset,
            int(q.dtype == torch.bfloat16), _stream(q))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    KERNEL_LAUNCHES["flash_mma_kernel" if q.dtype == torch.bfloat16
                    else "flash_fwd_kernel"] += 1
    return o, lse
