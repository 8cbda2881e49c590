"""Host layer around the Mamba2 SSD kernel, and the one-token decode step.

`mamba2_ssd` is the port of `repro/kernels/mamba2/ops.py:mamba2_ssd`: the
dt * A log-decay and its inclusive cumsum within each chunk (fp32,
`kernels/_common.py:chunk_cumsum`), the kernel call, the `+ x * D` skip
and the cast back to x's dtype.  Unlike the reference it neither repeats
B / C per head nor transposes into a [B, H, nc, Q, .] layout: the kernel
reads the projections as they are.
`decode_step` is the port of `repro/kernels/mamba2/ref.py:decode_step`,
which the reference computes outside any Pallas kernel; it stays plain
PyTorch here.

Training (the port of `repro/kernels/mamba2/ops.py:mamba2_ssd_trainable`):
`mamba2_ssd_trainable` is a `torch.autograd.Function` whose forward is
`mamba2_ssd` (the kernel on a CUDA tensor) and whose backward re-runs
`ssd_chunked_recompute`, the port of `ref.py:ssd_chunked` in
differentiable PyTorch ops, and differentiates it: the reference's
discipline of a kernel forward and the vjp of the jnp chunked form,
recomputed.  No Pallas backward kernel exists, so none is ported.

Shapes: x [B, L, H, P]; dt [B, L, H] (softplus'd, >= 0); a [H] (< 0);
b / c [B, L, G, N] with H % G == 0; d [H].
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels._common import chunk_cumsum, recompute_grads
from repro_torch.kernels.mamba2 import kernel as K


def mamba2_ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, c: torch.Tensor, d: torch.Tensor, *,
               chunk: int = 128, initial_state: torch.Tensor | None = None):
    """Chunked SSD forward.  Returns (y [B, L, H, P] in x's dtype, final
    state [B, H, N, P] fp32)."""
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    if l % chunk:
        raise ValueError(f"mamba2_ssd: chunk {chunk} must divide L = {l}")
    nc = l // chunk
    dtf = dt.float()
    la = dtf * a[None, None, :]
    a_cum = chunk_cumsum(la.reshape(bsz, nc, chunk, h)).reshape(bsz, l, h)
    s0 = (torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
          if initial_state is None else initial_state.float())
    y, s_fin = K.ssd_chunked_fwd(
        x.contiguous(), dtf.contiguous(), b.contiguous(), c.contiguous(),
        a_cum, s0.contiguous(), chunk=chunk)
    y = y + x.float() * d[None, None, :, None]
    return y.to(x.dtype), s_fin


def _expand_groups(bc: torch.Tensor, h: int) -> torch.Tensor:
    """[B, L, G, N] -> [B, L, H, N]: each group repeated for its H / G
    heads."""
    return bc.repeat_interleave(h // bc.shape[2], dim=2)


def ssd_chunked_recompute(x: torch.Tensor, dt: torch.Tensor,
                          a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                          d: torch.Tensor, *, chunk: int) -> torch.Tensor:
    """`ref.ssd_chunked` from the zero state in differentiable PyTorch
    ops: the intra-chunk decayed scores, the chunk states, the scan over
    chunks and the inter-chunk term, in fp32.  Returns y [B, L, H, P] in
    x's dtype.  The decays above the diagonal are masked before the exp
    (the reference masks after it): the same values, and no inf * 0 in
    the backward when a chunk's decay exceeds fp32's range."""
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    if l % chunk:
        raise ValueError(f"ssd_chunked_recompute: chunk {chunk} must divide "
                         f"L = {l}")
    nc = l // chunk
    xc = x.float().reshape(bsz, nc, chunk, h, p)
    dtc = dt.float().reshape(bsz, nc, chunk, h)
    bc = _expand_groups(b, h).float().reshape(bsz, nc, chunk, h, n)
    cc = _expand_groups(c, h).float().reshape(bsz, nc, chunk, h, n)
    a_cum = chunk_cumsum(dtc * a[None, None, None, :])  # [B, nc, Q, H]
    a_tot = a_cum[:, :, -1:, :]
    # intra-chunk: L[i, j] = exp(a_cum[i] - a_cum[j]) for i >= j
    seg = a_cum[:, :, :, None, :] - a_cum[:, :, None, :, :]  # [B,nc,Q,Q,H]
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()[None, None, :, :, None]
    lmat = torch.exp(torch.where(causal, seg, -torch.inf))
    scores = torch.einsum("bcqhn,bckhn->bcqkh", cc, bc) * lmat
    y = torch.einsum("bcqkh,bckhp->bcqhp", scores, dtc[..., None] * xc)
    # chunk states S_c = sum_j exp(a_tot - a_cum[j]) dt_j B_j x_j^T
    w = torch.exp(a_tot - a_cum) * dtc
    s_chunk = torch.einsum("bcqh,bcqhn,bcqhp->bchnp", w, bc, xc)
    # the scan over chunks: the state entering each chunk
    decay = torch.exp(a_tot[:, :, 0, :])  # [B, nc, H]
    s = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    s_in = []
    for i in range(nc):
        s_in.append(s)
        s = decay[:, i, :, None, None] * s + s_chunk[:, i]
    y = y + torch.einsum("bcqh,bcqhn,bchnp->bcqhp", torch.exp(a_cum), cc,
                         torch.stack(s_in, 1))
    y = y.reshape(bsz, l, h, p) + x.float() * d[None, None, :, None]
    return y.to(x.dtype)


class _SSDTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, a, b, c, d, chunk: int):
        ctx.save_for_backward(x, dt, a, b, c, d)
        ctx.chunk = chunk
        return mamba2_ssd(x, dt, a, b, c, d, chunk=chunk)[0]

    @staticmethod
    def backward(ctx, dy):
        return recompute_grads(ctx, functools.partial(
            ssd_chunked_recompute, chunk=ctx.chunk), dy)


def mamba2_ssd_trainable(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                         b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
                         *, chunk: int = 128) -> torch.Tensor:
    """The differentiable SSD of training, from the zero state: y [B, L,
    H, P] in x's dtype from `mamba2_ssd` (one kernel launch on the card),
    gradients for x, dt, a, b, c and d from the backward of
    `ssd_chunked_recompute` (PyTorch ops, no kernel launch)."""
    return _SSDTrainable.apply(x, dt, a, b, c, d, chunk)


def decode_step(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
                state: torch.Tensor):
    """One-token recurrence.  x [B, H, P], dt [B, H], b / c [B, G, N],
    state [B, H, N, P] fp32 -> (y [B, H, P] in x's dtype, new state)."""
    h = x.shape[1]
    bm = b.float().repeat_interleave(h // b.shape[1], dim=1)
    cm = c.float().repeat_interleave(h // c.shape[1], dim=1)
    xf = x.float()
    dtf = dt.float()
    da = torch.exp(dtf * a[None, :])
    new_state = da[..., None, None] * state + (
        dtf[..., None, None] * bm[..., :, None] * xf[..., None, :])
    y = torch.einsum("bhn,bhnp->bhp", cm, new_state) + xf * d[None, :, None]
    return y.to(x.dtype), new_state
