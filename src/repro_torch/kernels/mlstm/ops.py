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

Training (the port of `repro/kernels/mlstm/ops.py:mlstm_trainable`):
`mlstm_trainable` is a `torch.autograd.Function` whose forward is
`mlstm_chunked` from the zero state (the kernel on a CUDA tensor) and
whose backward re-runs `mlstm_chunked_recompute`, the port of
`ref.py:mlstm_chunked` in differentiable PyTorch ops (a loop over the
chunks), and differentiates it.  No Pallas backward kernel exists, so
none is ported.

Shapes: q, k, v [B, L, H, P]; igate / fgate preactivations [B, L, H];
state (C [B, H, P, P], n [B, H, P], m [B, H]) fp32, m = -inf the zero
state.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels._common import chunk_cumsum, recompute_grads
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


def mlstm_chunked_recompute(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, igate: torch.Tensor,
                            fgate: torch.Tensor, *,
                            chunk: int) -> torch.Tensor:
    """`ref.mlstm_chunked` from the zero state (`zero_state`: m = -inf) in
    differentiable PyTorch ops, a Python loop over the chunks, fp32, k
    scaled by P**-0.5 as `mlstm_trainable`'s forward scales it.
    Returns h [B, L, H, P] in q's dtype.  The decays above the diagonal
    are masked before the exp (the reference masks after it): the same
    values, and no inf * 0 in the backward."""
    bsz, l, h, p = q.shape
    if l % chunk:
        raise ValueError(f"mlstm_chunked_recompute: chunk {chunk} must "
                         f"divide L = {l}")
    nc = l // chunk
    qf = q.float().reshape(bsz, nc, chunk, h, p)
    kf = (k.float() * p ** -0.5).reshape(bsz, nc, chunk, h, p)
    vf = v.float().reshape(bsz, nc, chunk, h, p)
    ig = igate.float().reshape(bsz, nc, chunk, h)
    bcum = chunk_cumsum(F.logsigmoid(fgate.float()).reshape(bsz, nc, chunk,
                                                            h))
    ftot = bcum[:, :, -1, :]  # [B, nc, H]
    g = torch.cummax(ig - bcum, dim=2).values  # g_i = max_{j<=i}(i_j - b_j)
    gq = g[:, :, -1, :]
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=q.device).tril()[None, :, :, None]
    c_in, n_in, m_in = zero_state(bsz, h, p, q.device)
    hs = []
    for i in range(nc):
        qc, kc, vc, igc, bc = qf[:, i], kf[:, i], vf[:, i], ig[:, i], \
            bcum[:, i]
        # per-position stabiliser m_i = b_i + max(m_in, g_i)
        m_i = bc + torch.maximum(m_in[:, None, :], g[:, i])  # [B, Q, H]
        # intra-chunk decays w_ij = b_i - b_j + i_j - m_i, j <= i
        wmat = (bc[:, :, None, :] - bc[:, None, :, :] + igc[:, None, :, :]
                - m_i[:, :, None, :])  # [B, Qi, Qj, H]
        dmat = torch.exp(torch.where(causal, wmat, -torch.inf))
        scores = torch.einsum("bihp,bjhp->bijh", qc, kc) * dmat
        num = torch.einsum("bijh,bjhp->bihp", scores, vc)
        den_vec = torch.einsum("bijh,bjhp->bihp", dmat, kc)
        w_in = torch.exp(bc + m_in[:, None, :] - m_i)  # [B, Q, H]
        num = num + w_in[..., None] * torch.einsum("bihp,bhpd->bihd", qc,
                                                   c_in)
        den_vec = den_vec + w_in[..., None] * n_in[:, None, :, :]
        den = torch.maximum(
            torch.abs(torch.einsum("bihp,bihp->bih", qc, den_vec)),
            torch.exp(-m_i))
        hs.append(num / den[..., None])
        # the state leaving the chunk
        m_out = ftot[:, i] + torch.maximum(m_in, gq[:, i])  # [B, H]
        w_state = torch.exp(ftot[:, i, None, :] - bc + igc
                            - m_out[:, None, :])  # [B, Q, H]
        f_in = torch.exp(ftot[:, i] + m_in - m_out)
        c_in = f_in[..., None, None] * c_in + torch.einsum(
            "bjh,bjhp,bjhd->bhpd", w_state, kc, vc)
        n_in = f_in[..., None] * n_in + torch.einsum("bjh,bjhp->bhp",
                                                     w_state, kc)
        m_in = m_out
    return torch.stack(hs, 1).reshape(bsz, l, h, p).to(q.dtype)


class _MLSTMTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, igate, fgate, chunk: int):
        ctx.save_for_backward(q, k, v, igate, fgate)
        ctx.chunk = chunk
        return mlstm_chunked(q, k, v, igate, fgate, chunk=chunk)[0]

    @staticmethod
    def backward(ctx, dh):
        return recompute_grads(ctx, functools.partial(
            mlstm_chunked_recompute, chunk=ctx.chunk), dh)


def mlstm_trainable(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    igate: torch.Tensor, fgate: torch.Tensor, *,
                    chunk: int = 64) -> torch.Tensor:
    """The differentiable mLSTM of training, from the zero state: h [B, L,
    H, P] in q's dtype from `mlstm_chunked` (one kernel launch on the
    card), gradients for q, k, v and both gates from the backward of
    `mlstm_chunked_recompute` (PyTorch ops, no kernel launch)."""
    return _MLSTMTrainable.apply(q, k, v, igate, fgate, chunk)


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
