"""Mamba2 chunked SSD forward: the ctypes wrapper over
`csrc/mamba2_ssd.cu`, its launch counter, and its plain PyTorch version.

`ssd_chunked_fwd` is the port of the Pallas kernel
`repro/kernels/mamba2/kernel.py:ssd_chunked_fwd`.  It computes the same
function in the port's layout: x [B, L, H, P] and b / c [B, L, G, N] in
the model's dtype (fp32 or bf16), dt and a_cum [B, L, H] fp32 (a_cum the
inclusive cumsum of dt * A within each chunk of `chunk` tokens), s0
[B, H, N, P] fp32.  xdt = x * dt is formed in fp32 inside the kernel, and
B / C are read through the group h // (H / G) rather than repeated per
head.  Returns (y [B, L, H, P] fp32 without the D skip, final state
[B, H, N, P] fp32).  A CUDA tensor launches the kernel on the current
stream (or raises); a CPU tensor runs the plain version.  bf16 runs the
tensor-core kernel (`ssd_mma_kernel`: x, B and C must be 16-byte aligned,
else ValueError before the launch), fp32 the scalar one
(`ssd_fwd_kernel`); both take every shape below the limits.  Each kernel
launch adds one to `LAUNCHES["ssd_chunked_fwd"]` and one to the launched
kernel's `KERNEL_LAUNCHES` entry.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (_check_aligned, _plain, _ptr,
                                         _raise_on, _record, _route, _stream)
from repro_torch.roofline import analysis

MAX_CHUNK = 128  # tokens per chunk (rows of the in-block score tile)
MAX_STATE = 64   # state size N
_LIB_NAME = "mamba2_ssd"

LAUNCHES: dict[str, int] = {"ssd_chunked_fwd": 0}
# the same launches by CUDA kernel: the entry point sends bf16 to the
# tensor-core kernel and fp32 to the scalar one (by dtype, never as a
# fallback); the library says which (`ssd_chunked_fwd_uses_mma`)
KERNEL_LAUNCHES: dict[str, int] = {"ssd_mma_kernel": 0, "ssd_fwd_kernel": 0}


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
        f = lib.ssd_chunked_fwd
        f.argtypes = [_P] * 8 + [_I] * 8 + [_P]
        f.restype = _I
        lib.ssd_chunked_fwd_uses_mma.argtypes = [_I]
        lib.ssd_chunked_fwd_uses_mma.restype = _I
        _BOUND[id(lib)] = lib
    return lib


def ssd_chunked_fwd_plain(x, dt, b, c, a_cum, s0, *, chunk: int):
    """The kernel's function in PyTorch ops: the same per-chunk loop,
    carrying the fp32 state across chunks."""
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    nc = l // chunk
    xdt = (x.float() * dt[..., None]).reshape(bsz, nc, chunk, h, p)
    bm = b.float().repeat_interleave(h // g, dim=2).reshape(
        bsz, nc, chunk, h, n)
    cm = c.float().repeat_interleave(h // g, dim=2).reshape(
        bsz, nc, chunk, h, n)
    ac = a_cum.reshape(bsz, nc, chunk, h).permute(0, 1, 3, 2)  # [B,nc,H,Q]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    s = s0.float().clone()
    ys = []
    for ci in range(nc):
        a = ac[:, ci]  # [B, H, Q]
        a_tot = a[..., -1]  # [B, H]
        scores = torch.einsum("bihn,bjhn->bhij", cm[:, ci], bm[:, ci])
        seg = a[..., :, None] - a[..., None, :]
        lmat = torch.where(tri, torch.exp(seg), 0.0)
        y = torch.einsum("bhij,bjhp->bihp", scores * lmat, xdt[:, ci])
        y = y + torch.exp(a).transpose(1, 2)[..., None] * torch.einsum(
            "bihn,bhnp->bihp", cm[:, ci], s)
        w = torch.exp(a_tot[..., None] - a).transpose(1, 2)  # [B, Q, H]
        s = torch.exp(a_tot)[..., None, None] * s + torch.einsum(
            "bjhn,bjhp->bhnp", bm[:, ci] * w[..., None], xdt[:, ci])
        ys.append(y)
    y = torch.stack(ys, 1).reshape(bsz, l, h, p) if ys else \
        torch.zeros((bsz, l, h, p), dtype=torch.float32, device=x.device)
    return y, s


def ssd_chunked_fwd(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor, a_cum: torch.Tensor, s0: torch.Tensor,
                    *, chunk: int):
    """Chunked SSD forward.  x [B, L, H, P]; dt, a_cum [B, L, H] f32;
    b, c [B, L, G, N] in x's dtype; s0 [B, H, N, P] f32.  Returns (y
    [B, L, H, P] f32, final state [B, H, N, P] f32)."""
    name = "ssd_chunked_fwd"
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"{name}: x/b/c dtypes differ ({x.dtype}, "
                        f"{b.dtype}, {c.dtype})")
    for t, what in ((dt, "dt"), (a_cum, "a_cum"), (s0, "s0")):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {what} must be float32, got {t.dtype}")
    if x.ndim != 4:
        raise ValueError(f"{name}: x {tuple(x.shape)} must be [B, L, H, P]")
    bsz, l, h, p = x.shape
    if b.ndim != 4 or c.shape != b.shape or b.shape[:2] != (bsz, l) \
            or h % b.shape[2]:
        raise ValueError(f"{name}: b/c {tuple(b.shape)}, {tuple(c.shape)} "
                         f"must be [B={bsz}, L={l}, G | H={h}, N]")
    n = b.shape[3]
    if dt.shape != (bsz, l, h) or a_cum.shape != (bsz, l, h):
        raise ValueError(f"{name}: dt {tuple(dt.shape)} / a_cum "
                         f"{tuple(a_cum.shape)} must be [{bsz}, {l}, {h}]")
    if s0.shape != (bsz, h, n, p):
        raise ValueError(f"{name}: s0 {tuple(s0.shape)} must be "
                         f"[{bsz}, {h}, {n}, {p}]")
    if chunk <= 0 or l % chunk:
        raise ValueError(f"{name}: chunk {chunk} must divide L = {l}")
    route = _route(name, x, dt, b, c, a_cum, s0)
    _record(name, analysis.ssd_work, bsz=bsz, l=l, h=h, p=p, n=n,
            grp=b.shape[2], q=chunk, e=x.element_size())
    if route == "meta":
        return (torch.empty(x.shape, dtype=torch.float32, device=x.device),
                torch.empty_like(s0))
    if route == "cpu":
        return _plain(ssd_chunked_fwd_plain, x, dt, b, c, a_cum, s0,
                      chunk=chunk)
    for t in (x, dt, b, c, a_cum, s0):
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel needs contiguous "
                             f"tensors (got strides {t.stride()})")
    if chunk > MAX_CHUNK:
        raise ValueError(f"{name}: chunk {chunk} exceeds the CUDA kernel's "
                         f"{MAX_CHUNK} tokens")
    if n > MAX_STATE:
        raise ValueError(f"{name}: state size N = {n} exceeds the CUDA "
                         f"kernel's {MAX_STATE}")
    bf16 = int(x.dtype == torch.bfloat16)
    if bf16:  # the tensor-core kernel copies x, B and C with cp.async
        _check_aligned(name, x, b, c)
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    s_fin = torch.empty_like(s0)
    with torch.cuda.device(x.device):
        lib = library()
        rc = lib.ssd_chunked_fwd(
            _ptr(x), _ptr(dt), _ptr(b), _ptr(c), _ptr(a_cum), _ptr(s0),
            _ptr(y), _ptr(s_fin), bsz, l, h, p, n, b.shape[2], chunk, bf16,
            _stream(x))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    KERNEL_LAUNCHES["ssd_mma_kernel" if lib.ssd_chunked_fwd_uses_mma(bf16)
                    else "ssd_fwd_kernel"] += 1
    return y, s_fin
