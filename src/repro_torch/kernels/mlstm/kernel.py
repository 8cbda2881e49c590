"""Stabilised chunkwise mLSTM forward: the ctypes wrapper over
`csrc/mlstm_chunked.cu`, its launch counter, and its plain PyTorch
version.

`mlstm_chunked_fwd` is the port of the Pallas kernel
`repro/kernels/mlstm/kernel.py:mlstm_chunked_fwd`.  It computes the
function the model reaches through `repro/kernels/mlstm/ref.py:
mlstm_chunked`, which starts from a given state (the Pallas kernel always
starts from zeros), in the port's layout: q, k, v [B, L, H, P] in the
model's dtype (fp32 or bf16), k scaled by `scale` in fp32 inside the
kernel; ig, bcum and g [B, L, H] fp32 (the input-gate preactivations, the
inclusive cumsum of the log forget gates within each chunk of `chunk`
tokens, and cummax(ig - bcum) within the chunk); the initial state c0
[B, H, P, P], n0 [B, H, P], m0 [B, H] fp32 (m0 = -inf: the zero state).
Returns (h [B, L, H, P] in q's dtype, C [B, H, P, P], n [B, H, P],
m [B, H] fp32).  A CUDA tensor launches the kernel on the current stream
(or raises); a CPU tensor runs the plain version.  bf16 runs the
tensor-core kernel (`mlstm_mma_kernel`: q, k and v must be 16-byte
aligned, else ValueError before the launch), fp32 the scalar one
(`mlstm_fwd_kernel`); both take every shape below the limits.  Each
kernel launch adds one to `LAUNCHES["mlstm_chunked_fwd"]` and one to the
launched kernel's `KERNEL_LAUNCHES` entry.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (_check_aligned, _plain, _ptr,
                                         _raise_on, _record, _route, _stream)
from repro_torch.roofline import analysis

MAX_CHUNK = 64  # tokens per chunk (rows of the in-block score tile)
MAX_HEAD_DIM = 512  # P: a block's C tile [P, 64] (shared memory or registers)
_LIB_NAME = "mlstm_chunked"

LAUNCHES: dict[str, int] = {"mlstm_chunked_fwd": 0}
# the same launches by CUDA kernel: the entry point sends bf16 to the
# tensor-core kernel and fp32 to the scalar one (by dtype, never as a
# fallback); the library says which (`mlstm_chunked_fwd_uses_mma`)
KERNEL_LAUNCHES: dict[str, int] = {"mlstm_mma_kernel": 0,
                                   "mlstm_fwd_kernel": 0}


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
        f = lib.mlstm_chunked_fwd
        f.argtypes = [_P] * 13 + [_I] * 5 + [ctypes.c_float, _I, _P]
        f.restype = _I
        lib.mlstm_chunked_fwd_uses_mma.argtypes = [_I]
        lib.mlstm_chunked_fwd_uses_mma.restype = _I
        _BOUND[id(lib)] = lib
    return lib


def mlstm_chunked_fwd_plain(q, k, v, ig, bcum, g, c0, n0, m0, *,
                            chunk: int, scale: float):
    """The kernel's function in PyTorch ops: the reference's per-chunk
    loop (`ref.py:mlstm_chunked`'s `chunk_step`), in its order of
    operations, carrying the fp32 state across chunks."""
    bsz, l, h, p = q.shape
    nc = l // chunk

    def chunks(t):  # [B, L, ...] -> [B, nc, Q, ...]
        return t.reshape((bsz, nc, chunk) + tuple(t.shape[2:]))

    qf, kf, vf = chunks(q.float()), chunks(k.float() * scale), \
        chunks(v.float())
    igc, bc, gc = chunks(ig), chunks(bcum), chunks(g)  # [B, nc, Q, H]
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=q.device))[None, :, :, None]
    c, n, m = c0.float().clone(), n0.float().clone(), m0.float().clone()
    hs = []
    for ci in range(nc):
        qc, kc, vc = qf[:, ci], kf[:, ci], vf[:, ci]  # [B, Q, H, P]
        ic, b_, g_ = igc[:, ci], bc[:, ci], gc[:, ci]  # [B, Q, H]
        ftot, gq = b_[:, -1], g_[:, -1]  # [B, H]
        m_i = b_ + torch.maximum(m[:, None, :], g_)
        wmat = (b_[:, :, None, :] - b_[:, None, :, :] + ic[:, None, :, :]
                - m_i[:, :, None, :])  # [B, Qi, Qj, H]
        dmat = torch.where(causal, torch.exp(wmat), 0.0)
        scores = torch.einsum("bihp,bjhp->bijh", qc, kc) * dmat
        num = torch.einsum("bijh,bjhp->bihp", scores, vc)
        den_vec = torch.einsum("bijh,bjhp->bihp", dmat, kc)
        w_in = torch.exp(b_ + m[:, None, :] - m_i)  # [B, Q, H]
        num = num + w_in[..., None] * torch.einsum("bihp,bhpd->bihd", qc, c)
        den_vec = den_vec + w_in[..., None] * n[:, None, :, :]
        den = torch.maximum(
            torch.abs(torch.einsum("bihp,bihp->bih", qc, den_vec)),
            torch.exp(-m_i))
        hs.append(num / den[..., None])
        m_out = ftot + torch.maximum(m, gq)
        w_state = torch.exp(ftot[:, None, :] - b_ + ic - m_out[:, None, :])
        decay = torch.exp(ftot + m - m_out)
        kw = kc * w_state[..., None]
        c = decay[..., None, None] * c + torch.einsum("bjhp,bjhd->bhpd", kw,
                                                      vc)
        n = decay[..., None] * n + kw.sum(1)
        m = m_out
    hout = (torch.stack(hs, 1).reshape(bsz, l, h, p) if hs else
            torch.zeros((bsz, l, h, p), dtype=torch.float32,
                        device=q.device))
    return hout.to(q.dtype), c, n, m


def mlstm_chunked_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      ig: torch.Tensor, bcum: torch.Tensor, g: torch.Tensor,
                      c0: torch.Tensor, n0: torch.Tensor, m0: torch.Tensor,
                      *, chunk: int, scale: float):
    """Chunked mLSTM forward from the state (c0, n0, m0).  q, k, v
    [B, L, H, P] (fp32 or bf16); ig, bcum, g [B, L, H] f32; c0
    [B, H, P, P], n0 [B, H, P], m0 [B, H] f32.  Returns (h [B, L, H, P] in
    q's dtype, C, n, m f32)."""
    name = "mlstm_chunked_fwd"
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: q must be float32 or bfloat16, got "
                        f"{q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v dtypes differ ({q.dtype}, "
                        f"{k.dtype}, {v.dtype})")
    for t, what in ((ig, "ig"), (bcum, "bcum"), (g, "g"), (c0, "c0"),
                    (n0, "n0"), (m0, "m0")):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {what} must be float32, got {t.dtype}")
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q/k/v {tuple(q.shape)}, {tuple(k.shape)},"
                         f" {tuple(v.shape)} must be one [B, L, H, P]")
    bsz, l, h, p = q.shape
    for t, what in ((ig, "ig"), (bcum, "bcum"), (g, "g")):
        if t.shape != (bsz, l, h):
            raise ValueError(f"{name}: {what} {tuple(t.shape)} must be "
                             f"[{bsz}, {l}, {h}]")
    if c0.shape != (bsz, h, p, p) or n0.shape != (bsz, h, p) \
            or m0.shape != (bsz, h):
        raise ValueError(f"{name}: state {tuple(c0.shape)}, "
                         f"{tuple(n0.shape)}, {tuple(m0.shape)} must be "
                         f"[{bsz}, {h}, {p}, {p}], [{bsz}, {h}, {p}], "
                         f"[{bsz}, {h}]")
    if chunk <= 0 or l % chunk:
        raise ValueError(f"{name}: chunk {chunk} must divide L = {l}")
    args = (q, k, v, ig, bcum, g, c0, n0, m0)
    route = _route(name, *args)
    _record(name, analysis.mlstm_work, bsz=bsz, l=l, h=h, p=p, q=chunk,
            e=q.element_size())
    if route == "meta":
        return (torch.empty_like(q),
                *(torch.empty_like(t) for t in (c0, n0, m0)))
    if route == "cpu":
        return _plain(mlstm_chunked_fwd_plain, *args, chunk=chunk,
                      scale=scale)
    for t in args:
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel needs contiguous "
                             f"tensors (got strides {t.stride()})")
    if chunk > MAX_CHUNK:
        raise ValueError(f"{name}: chunk {chunk} exceeds the CUDA kernel's "
                         f"{MAX_CHUNK} tokens")
    if p > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim P = {p} exceeds the CUDA "
                         f"kernel's {MAX_HEAD_DIM}")
    bf16 = int(q.dtype == torch.bfloat16)
    if bf16:  # the tensor-core kernel copies q, k and v with cp.async
        _check_aligned(name, q, k, v)
    hout = torch.empty_like(q)
    c_fin, n_fin, m_fin = (torch.empty_like(t) for t in (c0, n0, m0))
    with torch.cuda.device(q.device):
        lib = library()
        rc = lib.mlstm_chunked_fwd(
            *(_ptr(t) for t in args), _ptr(hout), _ptr(c_fin), _ptr(n_fin),
            _ptr(m_fin), bsz, l, h, p, chunk, float(scale), bf16, _stream(q))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    KERNEL_LAUNCHES["mlstm_mma_kernel"
                    if lib.mlstm_chunked_fwd_uses_mma(bf16)
                    else "mlstm_fwd_kernel"] += 1
    return hout, c_fin, n_fin, m_fin
