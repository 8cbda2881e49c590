"""Host layer around the Mamba2 SSD kernel, and the one-token decode step.

`mamba2_ssd` is the port of `repro/kernels/mamba2/ops.py:mamba2_ssd`: the
dt * A log-decay and its inclusive cumsum within each chunk (fp32,
`chunk_cumsum`), the kernel call, the `+ x * D` skip and the cast back to
x's dtype.  Unlike the reference it neither repeats B / C per head nor
transposes into a [B, H, nc, Q, .] layout: the kernel reads the
projections as they are.
`decode_step` is the port of `repro/kernels/mamba2/ref.py:decode_step`,
which the reference computes outside any Pallas kernel; it stays plain
PyTorch here.

Shapes: x [B, L, H, P]; dt [B, L, H] (softplus'd, >= 0); a [H] (< 0);
b / c [B, L, G, N] with H % G == 0; d [H].
"""
from __future__ import annotations

import torch

from repro_torch.kernels.mamba2 import kernel as K


def _running_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive fp32 prefix sum along `dim`, added strictly left to
    right."""
    sums = [x.select(dim, 0)]
    for i in range(1, x.shape[dim]):
        sums.append(sums[-1] + x.select(dim, i))
    return torch.stack(sums, dim)


def chunk_cumsum(la: torch.Tensor) -> torch.Tensor:
    """Inclusive fp32 cumsum over axis 2 of la [B, nc, Q, H], added in the
    order of the reference's `jnp.cumsum` on the CPU (XLA's reduce-window
    rewrite): left to right within blocks of 16, each block then offset by
    the left-to-right sum of the blocks before it.  Every decay of the SSD
    is exp of a difference of these sums and multiplies terms as large as
    |y|, so one rounding apart in a_cum shows in y above the tests'
    3e-5; in this order a_cum equals the reference's bit for bit, on the
    card as on the CPU."""
    q = la.shape[2]
    if q <= 16 or q % 16:
        return _running_sum(la, 2)
    inner = _running_sum(la.unflatten(2, (q // 16, 16)), 3)
    tot = inner[:, :, :, -1]
    before = torch.cat([torch.zeros_like(tot[:, :, :1]),
                        _running_sum(tot, 2)[:, :, :-1]], 2)
    return (inner + before[:, :, :, None]).flatten(2, 3)


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
