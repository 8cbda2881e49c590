"""Flash-attention forward: the ctypes wrapper over
`csrc/flash_attention.cu`, its launch counter, and its plain PyTorch
version.

`flash_attention_fwd` is the port of the Pallas kernel
`repro/kernels/flash_attention/kernel.py:flash_attention_fwd`, with the
same packed inputs (q [B*Hkv, nq, block_q * group, D], row = tok * group
+ g; k / v [B*Hkv, Skv, D]).  It also returns the fp32 row logsumexp the
backward needs.  KV is walked in tiles of `KV_TILE` keys; since p is
rounded to V's dtype under the running max of its tile, the plain
version uses the same tile, so in bf16 the two agree to the rounding of
the output.  A CUDA tensor launches the kernel on the current stream (or
raises): the tensor-core kernel in bf16 (head dim 64 or 128; another
head dim raises), the scalar fp32 kernel in fp32.  A CPU tensor runs the
plain version.  Each kernel launch adds
one to `LAUNCHES["flash_attention_fwd"]`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (
    NEG_INF, _check_mma, _finalize, _init_state, _on_card, _ptr, _raise_on,
    _stream, _tile_update,
)
from repro_torch.utils.misc import cdiv

MAX_ROWS = 64  # block_q * group rows of one thread block
KV_TILE = 64   # keys per KV tile
MAX_HEAD_DIM = 256
_LIB_NAME = "flash_attention"

LAUNCHES: dict[str, int] = {"flash_attention_fwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int
_BOUND: dict[int, ctypes.CDLL] = {}


def library() -> ctypes.CDLL:
    """The kernel's shared library, built from csrc/ at first use."""
    lib = _build.load(_LIB_NAME)
    if id(lib) not in _BOUND:
        f = lib.fa_flash_attention_fwd
        f.argtypes = [_P] * 5 + [_I] * 7 + [ctypes.c_float, _I, _I, _I, _P]
        f.restype = _I
        _BOUND[id(lib)] = lib
    return lib


def flash_attention_fwd_plain(q, k, v, *, block_q: int, group: int,
                              scale: float, causal: bool, q_offset: int):
    """The kernel's function in PyTorch ops: online softmax over KV tiles
    of KV_TILE keys.  Returns (o in q's dtype, lse [BH, nq, BM] f32)."""
    bh, nq, bm, d = q.shape
    skv = k.shape[1]
    dev = q.device
    q_pos = (q_offset + torch.arange(nq, device=dev)[:, None] * block_q
             + torch.arange(bm, device=dev)[None, :] // group)  # [nq, BM]
    n_t = cdiv(skv, KV_TILE)
    if causal:
        n_t = min(n_t, cdiv(q_offset + nq * block_q, KV_TILE))
    qf = q.float()
    acc, m, l = _init_state(q.shape, dev)
    for t in range(n_t):
        kt = k[:, None, t * KV_TILE:(t + 1) * KV_TILE]  # [BH, 1, tile, D]
        vt = v[:, None, t * KV_TILE:(t + 1) * KV_TILE]
        kv_pos = t * KV_TILE + torch.arange(kt.shape[2], device=dev)
        mask = (kv_pos[None, None, :] <= q_pos[:, :, None]) if causal else \
            torch.ones((nq, bm, kv_pos.numel()), dtype=torch.bool, device=dev)
        acc, m, l = _tile_update(qf, kt, vt, mask.expand(bh, -1, -1, -1),
                                 scale, acc, m, l)
    lse = torch.where(l == 0.0, NEG_INF,
                      m + torch.log(torch.where(l == 0.0, 1.0, l)))
    return _finalize(acc, l, q.dtype), lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, block_q: int, group: int, scale: float,
                        causal: bool, q_offset: int):
    """Dense (causal) GQA flash-attention forward.  q [BH, nq, block_q *
    group, D] packed with row = tok * group + g; k / v [BH, Skv, D]; the
    query token at row r of block qi sits at q_offset + qi * block_q +
    r // group.  Returns (o like q, lse [BH, nq, block_q * group] f32,
    -0.7 * f32 max where a row saw no live key)."""
    name = "flash_attention_fwd"
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v dtypes differ "
                        f"({q.dtype}, {k.dtype}, {v.dtype})")
    if q.ndim != 4 or q.shape[2] != block_q * group:
        raise ValueError(f"{name}: q {tuple(q.shape)} must be [BH, nq, "
                         f"block_q*group={block_q * group}, D]")
    if k.ndim != 3 or v.shape != k.shape or k.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[3]:
        raise ValueError(f"{name}: k/v {tuple(k.shape)}, {tuple(v.shape)} "
                         f"must be [BH={q.shape[0]}, Skv, D={q.shape[3]}]")
    if q_offset < 0:
        raise ValueError(f"{name}: q_offset must be >= 0, got {q_offset}")
    if not _on_card(name, q, k, v):
        return flash_attention_fwd_plain(q, k, v, block_q=block_q,
                                         group=group, scale=scale,
                                         causal=causal, q_offset=q_offset)
    bh, nq, bm, d = q.shape
    for t in (q, k, v):
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel needs contiguous "
                             f"tensors (got strides {t.stride()})")
    if d > MAX_HEAD_DIM or d % 8:
        raise ValueError(f"{name}: head_dim {d} unsupported by the CUDA "
                         f"kernel (multiples of 8 up to {MAX_HEAD_DIM})")
    if q.dtype == torch.bfloat16:
        _check_mma(name, d, q, k, v)
    if bm > MAX_ROWS:
        raise ValueError(f"{name}: block_q * group = {bm} rows exceeds the "
                         f"kernel's {MAX_ROWS}")
    o = torch.empty_like(q)
    lse = torch.empty((bh, nq, bm), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = library().fa_flash_attention_fwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(lse), bh, nq, bm, d,
            k.shape[1], block_q, group, scale, int(causal), q_offset,
            int(q.dtype == torch.bfloat16), _stream(q))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return o, lse
