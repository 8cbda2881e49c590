"""Host layer around the chunked mLSTM kernel, and the one-token decode
step.

`mlstm_chunked` is the port of `repro/kernels/mlstm/ref.py:mlstm_chunked`
(the function the mLSTM block's prefill calls, with an initial state) and
of the host part of `repro/kernels/mlstm/ops.py:mlstm`: the log forget
gates `logsigmoid(fgate)` in fp32, their inclusive cumsum within each
chunk (`kernels/_common.py:chunk_cumsum`, in the reference's order of
addition), g = cummax(ig - bcum) within the chunk, the kernel call (which
reads q, k, v in their dtype and scales k by P**-0.5 in fp32) and h in
q's dtype.  Unlike the reference it does not transpose into a
[B, H, nc, Q, P] layout: the kernel reads the projections as they are.
`decode_step` is the port of `ref.py:decode_step`, which the reference
computes outside any Pallas kernel; it stays plain PyTorch here.

Shapes: q, k, v [B, L, H, P]; igate / fgate preactivations [B, L, H];
state (C [B, H, P, P], n [B, H, P], m [B, H]) fp32, m = -inf the zero
state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels._common import chunk_cumsum
from repro_torch.kernels.mlstm import kernel as K


def zero_state(bsz: int, h: int, p: int, device) \
        -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(C, n, m) of an empty memory: zeros, and the stabiliser at -inf."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros((bsz, h, p, p), **f32),
            torch.zeros((bsz, h, p), **f32),
            torch.full((bsz, h), -torch.inf, **f32))


def mlstm_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  igate: torch.Tensor, fgate: torch.Tensor, *,
                  chunk: int = 64, initial_state=None,
                  scale: float | None = None):
    """Stabilised chunkwise mLSTM.  Returns (h [B, L, H, P] in q's dtype,
    (C, n, m) final state fp32)."""
    bsz, l, h, p = q.shape
    if scale is None:
        scale = p ** -0.5
    if l % chunk:
        raise ValueError(f"mlstm_chunked: chunk {chunk} must divide L = {l}")
    nc = l // chunk
    ig = igate.float().contiguous()
    lf = F.logsigmoid(fgate.float())
    bcum = chunk_cumsum(lf.reshape(bsz, nc, chunk, h))
    g = torch.cummax(ig.reshape(bsz, nc, chunk, h) - bcum, dim=2).values
    c0, n0, m0 = (zero_state(bsz, h, p, q.device) if initial_state is None
                  else initial_state)
    hs, c, n, m = K.mlstm_chunked_fwd(
        q.contiguous(), k.contiguous(), v.contiguous(), ig,
        bcum.reshape(bsz, l, h), g.reshape(bsz, l, h),
        c0.float().contiguous(), n0.float().contiguous(),
        m0.float().contiguous(), chunk=chunk, scale=scale)
    return hs, (c, n, m)


def decode_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                igate: torch.Tensor, fgate: torch.Tensor, state, *,
                scale: float | None = None):
    """One-token update.  q, k, v [B, H, P]; gates [B, H]; state (C, n, m)
    -> (h [B, H, P] in q's dtype, new state)."""
    p = q.shape[-1]
    if scale is None:
        scale = p ** -0.5
    c, n, m = state
    qf = q.float()
    kf = k.float() * scale
    vf = v.float()
    i_t = igate.float()
    lf_t = F.logsigmoid(fgate.float())
    m_new = torch.maximum(lf_t + m, i_t)
    ip = torch.exp(i_t - m_new)
    fp = torch.exp(lf_t + m - m_new)
    c = fp[..., None, None] * c + ip[..., None, None] * (
        kf[..., :, None] * vf[..., None, :])
    n = fp[..., None] * n + ip[..., None] * kf
    num = torch.einsum("bhp,bhpd->bhd", qf, c)
    den = torch.maximum(torch.abs(torch.einsum("bhp,bhp->bh", qf, n)),
                        torch.exp(-m_new))
    return (num / den[..., None]).to(q.dtype), (c, n, m_new)
