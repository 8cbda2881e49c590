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
the device: the kernel's grid is fixed by (N, E), so the launch reads no
group size on the host and captures into a CUDA graph.

A CUDA tensor launches the kernel on the current stream (or raises); a
CPU tensor runs the plain version, a loop over the experts that reads
the offsets on the host.  bf16 runs the tensor-core kernel
(`moe_mma_kernel`: operands 16-byte aligned, else ValueError before the
launch), fp32 the scalar one (`moe_fp32_kernel`).  Each kernel launch
adds one to `LAUNCHES["moe_grouped_gemm"]` and one to the launched
kernel's `KERNEL_LAUNCHES` entry.  The wrapper cannot read the device's
offsets without a host sync, so the kernel checks them (0 <= offsets[e]
<= offsets[e + 1] <= offsets[E] == R, or <= R with `tail`) and traps on a violation; the
plain version raises ValueError.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels._common import (_check_aligned, _on_card, _ptr,
                                         _raise_on, _stream)

NAME = "moe_grouped_gemm"
_LIB_NAME = "moe_grouped_gemm"

LAUNCHES: dict[str, int] = {NAME: 0}
# the same launches by CUDA kernel, chosen by dtype (never as a fallback)
KERNEL_LAUNCHES: dict[str, int] = {"moe_mma_kernel": 0, "moe_fp32_kernel": 0}


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
                 tail: bool = False) -> torch.Tensor:
    """xs [R, K] sorted by expert; w0 (and w1) [E, K, N] in xs's dtype;
    offsets [E + 1] int32.  Returns [R, N] in xs's dtype:
    xs . w0[e], or silu(xs . w0[e]) * (xs . w1[e]) with `w1`; with `tail`
    zeros on the rows past offsets[E]."""
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
    if not _on_card(NAME, xs, offsets, *ws):
        return grouped_gemm_plain(xs, w0, offsets, w1, tail=tail)
    for t in (xs, offsets, *ws):
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: the CUDA kernel needs contiguous "
                             f"tensors (got strides {t.stride()})")
    bf16 = int(xs.dtype == torch.bfloat16)
    if bf16:  # the tensor-core kernel copies its tiles with cp.async
        _check_aligned(NAME, xs, *ws)
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
    KERNEL_LAUNCHES["moe_mma_kernel" if lib.moe_grouped_gemm_uses_mma(bf16)
                    else "moe_fp32_kernel"] += 1
    return out
