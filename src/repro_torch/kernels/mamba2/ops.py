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

Shapes: x [B, L, H, P]; dt [B, L, H] (softplus'd, >= 0); a [H] (< 0);
b / c [B, L, G, N] with H % G == 0; d [H].
"""
from __future__ import annotations

import torch

from repro_torch.kernels._common import chunk_cumsum
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
