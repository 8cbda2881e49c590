"""Grouped expert GEMM: the ctypes wrapper over `csrc/moe_grouped_gemm.cu`,
its launch counter, and its plain PyTorch version.

`grouped_gemm` computes, for rows xs [R, K] sorted by expert and offsets
[E + 1] int32 (expert e's rows are [offsets[e], offsets[e + 1]), the last
offset R), out [R, N] = xs . w0[e] over each expert's rows, or with `w1`
the SwiGLU pair silu(xs . w0[e]) * (xs . w1[e]) in one launch; w0 / w1
[E, K, N].  With `tail=True` the groups may end before R (offsets[E] <=
R): the rows past offsets[E] belong to no expert and come out zero, as
`jax.lax.ragged_dot` leaves rows outside every group (the
expert-parallel MoE's rows routed to other ranks).  It is the product the reference computes with
`jax.lax.ragged_dot` in `repro/models/moe.py:moe_ffn_dropless`, outside
any Pallas kernel: no Pallas kernel is replaced.  The offsets stay on
the device: the kernel's grid is fixed by the shapes, so the launch
reads no group size on the host and captures into a CUDA graph.

A CUDA tensor launches the kernel on the current stream (or raises); a
CPU tensor runs the plain version, a loop over the experts that reads
the offsets on the host.  bf16 runs the tensor-core kernel
(`moe_wgmma_kernel`: operands 16-byte aligned, K and N multiples of 8 so
that TMA's row strides are 16-byte multiples, at most `MAX_EXPERTS`
experts, else ValueError before the launch), fp32 the scalar one
(`moe_fp32_kernel`).  Each kernel launch adds one to
`LAUNCHES["moe_grouped_gemm"]` and one to the launched kernel's
`KERNEL_LAUNCHES` entry.  The wrapper cannot read the device's offsets
without a host sync, so the kernel checks them (0 <= offsets[e] <=
offsets[e + 1] <= offsets[E] == R, or <= R with `tail`) and traps on a
violation; the plain version raises ValueError.

The bf16 kernel is a persistent grid over the touched experts' tiles:
`launch_shape` is the host's choice of its tile and grid for (R, E, N)
and `tile_schedule` the order in which its blocks take the tiles, both
written here in PyTorch as mirrors of `csrc/moe_grouped_gemm.cu` (the
CPU tests check the schedule's coverage; the card tests hold
`launch_shape` to the library's own).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels._common import (_check_aligned, _plain, _ptr,
                                         _raise_on, _record, _route, _stream)
from repro_torch.roofline import analysis

NAME = "moe_grouped_gemm"
_LIB_NAME = "moe_grouped_gemm"

LAUNCHES: dict[str, int] = {NAME: 0}
# the same launches by CUDA kernel, chosen by dtype (never as a fallback)
KERNEL_LAUNCHES: dict[str, int] = {"moe_wgmma_kernel": 0,
                                   "moe_fp32_kernel": 0}
# the bf16 kernel's tile: rows (two consumer warpgroups of 64) and output
# columns (gate / up: 128 of each product; down: 256); its shared-memory
# plan holds the offsets of at most MAX_EXPERTS experts
TILE_ROWS = 128
TILE_COLS = {True: 128, False: 256}
MAX_EXPERTS = 1024


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
        f = lib.moe_grouped_gemm
        f.argtypes = [_P] * 5 + [_I] * 7 + [_P]
        f.restype = _I
        lib.moe_grouped_gemm_uses_mma.argtypes = [_I]
        lib.moe_grouped_gemm_uses_mma.restype = _I
        lib.moe_grouped_gemm_shape.argtypes = [_I] * 4 + [_P] * 3
        lib.moe_grouped_gemm_shape.restype = None
        _BOUND[id(lib)] = lib
    return lib


def group_bounds(offsets: torch.Tensor, rows: int,
                 tail: bool = False) -> list[int]:
    """The offsets on the host, checked against the contract."""
    bounds = [int(v) for v in offsets.tolist()]
    end_ok = bounds[-1] <= rows if tail else bounds[-1] == rows
    if not end_ok or bounds[0] < 0 or any(
            a > b for a, b in zip(bounds, bounds[1:])):
        raise ValueError(f"{NAME}: offsets {bounds} must rise from >= 0 to "
                         f"{'at most ' if tail else ''}R = {rows}")
    return bounds


def launch_shape(r: int, e: int, n: int, glu: bool,
                 sms: int) -> tuple[int, int, int]:
    """(rows a tile, output columns a tile, grid) of the bf16 kernel for
    R rows over E experts and N output columns on a card of `sms` SMs:
    min(sms, an upper bound on the tiles), from the shapes alone (each
    expert with rows adds at most one partial row tile).  The mirror of
    `wgmma_grid` in `csrc/moe_grouped_gemm.cu`."""
    bm, bn = TILE_ROWS, TILE_COLS[bool(glu)]
    if r <= 0:
        return bm, bn, 0
    row_tiles = (r + min(e, r) * (bm - 1)) // bm
    return bm, bn, min(sms, row_tiles * -(-n // bn))


def tile_schedule(offsets: torch.Tensor | list[int], bm: int, bn: int,
                  n: int, tail: bool = False,
                  rows: int | None = None) -> torch.Tensor:
    """The bf16 kernel's tiles in the order its blocks take them (block b
    takes tile b, then the next id no block has taken): int64 [T, 4] of
    (expert, first row, live rows, first column).  Experts in order, an
    expert's tiles n-tile by n-tile, and the row tiles of one (expert,
    n-tile) next to each other; an expert with no rows gives none, and no
    tile reaches past offsets[E].  The offsets [E + 1] of R rows (default
    offsets[E]) are checked as the kernel checks them (`group_bounds`:
    ending at R, or with `tail` at most at R).  The mirror of `tile_at`
    in `csrc/moe_grouped_gemm.cu`."""
    bounds = group_bounds(torch.as_tensor(offsets),
                          int(offsets[-1]) if rows is None else rows, tail)
    lo = torch.tensor(bounds[:-1], dtype=torch.int64)
    count = torch.tensor(bounds[1:], dtype=torch.int64) - lo
    mt = -(-count // bm)                      # row tiles an expert
    nt = -(-n // bn)
    e = torch.repeat_interleave(torch.arange(len(count)), mt * nt)
    first = torch.repeat_interleave(torch.cumsum(mt * nt, 0) - mt * nt,
                                    mt * nt)
    local = torch.arange(int((mt * nt).sum())) - first
    n_i, m_i = local // mt[e], local % mt[e]
    r0 = lo[e] + m_i * bm
    live = torch.minimum(torch.full_like(r0, bm), lo[e] + count[e] - r0)
    return torch.stack([e, r0, live, n_i * bn], dim=1)


def grouped_gemm_plain(xs: torch.Tensor, w0: torch.Tensor,
                       offsets: torch.Tensor,
                       w1: torch.Tensor | None = None, *,
                       tail: bool = False) -> torch.Tensor:
    """The kernel's function in PyTorch ops: one product (two with `w1`)
    per expert that has rows, in the operands' dtype."""
    bounds = group_bounds(offsets, xs.shape[0], tail)
    out = (torch.zeros if tail else torch.empty)(
        (xs.shape[0], w0.shape[2]), dtype=xs.dtype, device=xs.device)
    for e, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
        if hi == lo:
            continue
        a = xs[lo:hi]
        out[lo:hi] = (a @ w0[e] if w1 is None
                      else F.silu(a @ w0[e]) * (a @ w1[e]))
    return out


def grouped_gemm(xs: torch.Tensor, w0: torch.Tensor, offsets: torch.Tensor,
                 w1: torch.Tensor | None = None, *,
                 tail: bool = False,
                 routed_rows: int | None = None) -> torch.Tensor:
    """xs [R, K] sorted by expert; w0 (and w1) [E, K, N] in xs's dtype;
    offsets [E + 1] int32.  Returns [R, N] in xs's dtype:
    xs . w0[e], or silu(xs . w0[e]) * (xs . w1[e]) with `w1`; with `tail`
    zeros on the rows past offsets[E].  The recorded work counts
    `routed_rows` rows (default R: every row; the offsets stay on the
    device, so the rows a tail leaves alone are the caller's estimate)."""
    if xs.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{NAME}: xs must be float32 or bfloat16, got "
                        f"{xs.dtype}")
    ws = (w0,) if w1 is None else (w0, w1)
    for w in ws:
        if w.dtype != xs.dtype:
            raise TypeError(f"{NAME}: weights {w.dtype} must match xs "
                            f"{xs.dtype}")
    if offsets.dtype != torch.int32:
        raise TypeError(f"{NAME}: offsets must be int32, got "
                        f"{offsets.dtype}")
    if xs.ndim != 2 or w0.ndim != 3 or w0.shape[1] != xs.shape[1]:
        raise ValueError(f"{NAME}: xs {tuple(xs.shape)} / w0 "
                         f"{tuple(w0.shape)} must be [R, K] / [E, K, N]")
    if w1 is not None and w1.shape != w0.shape:
        raise ValueError(f"{NAME}: w1 {tuple(w1.shape)} must match w0 "
                         f"{tuple(w0.shape)}")
    r, k = xs.shape
    e, _, n = w0.shape
    if offsets.shape != (e + 1,):
        raise ValueError(f"{NAME}: offsets {tuple(offsets.shape)} must be "
                         f"[E + 1 = {e + 1}]")
    route = _route(NAME, xs, offsets, *ws)
    _record(NAME, analysis.grouped_gemm_work,
            rows=r if routed_rows is None else routed_rows, touched=e, k=k,
            n=n, n_w=len(ws), e=xs.element_size())
    if route == "meta":
        return torch.empty((r, n), dtype=xs.dtype, device=xs.device)
    if route == "cpu":
        return _plain(grouped_gemm_plain, xs, w0, offsets, w1, tail=tail)
    for t in (xs, offsets, *ws):
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: the CUDA kernel needs contiguous "
                             f"tensors (got strides {t.stride()})")
    bf16 = int(xs.dtype == torch.bfloat16)
    if bf16:  # the tensor-core kernel reads its tiles through TMA
        _check_aligned(NAME, xs, *ws)
        if k % 8 or n % 8:
            raise ValueError(f"{NAME}: the bf16 kernel's TMA needs 16-byte "
                             f"row strides: K {k} and N {n} must be "
                             f"multiples of 8")
        if e > MAX_EXPERTS:
            raise ValueError(f"{NAME}: the bf16 kernel takes at most "
                             f"{MAX_EXPERTS} experts, got {e}")
    out = (torch.zeros if tail else torch.empty)(
        (r, n), dtype=xs.dtype, device=xs.device)
    with torch.cuda.device(xs.device):
        lib = library()
        rc = lib.moe_grouped_gemm(
            _ptr(xs), _ptr(w0), _ptr(w0 if w1 is None else w1),
            _ptr(offsets), _ptr(out), r, e, k, n, int(w1 is not None), bf16,
            int(tail), _stream(xs))
    _raise_on(rc, NAME)
    LAUNCHES[NAME] += 1
    KERNEL_LAUNCHES["moe_wgmma_kernel" if lib.moe_grouped_gemm_uses_mma(bf16)
                    else "moe_fp32_kernel"] += 1
    return out
