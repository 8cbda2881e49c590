"""Differentiable GQA flash attention: the hand-written forward kernel and
the recompute backward of the reference.

`flash_attention(q, k, v)` is the port of
`repro/kernels/flash_attention/ops.py:flash_attention`, as a
`torch.autograd.Function`:

  forward   packs q to [B, Hkv, Sq*G, D] (row = tok * G + g: the G query
            heads that share a KV head are rows of one block) and runs
            `kernel.flash_attention_fwd` (the CUDA kernel on a CUDA
            tensor, its plain version on a CPU tensor), which also
            returns the row logsumexp.  It saves the packed q, k, v, o
            and lse: nothing larger.
  backward  the port of `ref._flash_vjp_bwd`: per KV block, P is
            recomputed from q, k and the saved lse, then dS = P * (dP -
            delta) gives dq, dk and dv, in fp32 PyTorch ops on the same
            packed rows.  The reference runs this backward in XLA outside
            any Pallas kernel, so there is no backward kernel to port.
            Under causal masking the query rows that precede a KV block
            are sliced off: their P is exactly zero there.

D is not padded to the TPU's 128 lanes.  The forward also takes a value
width other than the key width and a per-batch `kv_len` (MLA's expanded
prefill, serving only): the backward raises on either until MLA training
is ported.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels._common import NEG_INF

BWD_KV_BLOCK = 1024  # keys per backward block (the reference's training kv_block)


def pick_block_q(sq: int, group: int) -> int:
    """The largest power of two dividing sq with block_q * group <=
    K.MAX_ROWS rows per thread block."""
    if group > K.MAX_ROWS:
        raise ValueError(f"flash_attention: group {group} exceeds the "
                         f"kernel's {K.MAX_ROWS} rows per block")
    bq = 1
    while bq * 2 * group <= K.MAX_ROWS and sq % (bq * 2) == 0:
        bq *= 2
    return bq


def pack_q(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """[B, S, Hkv*G, D] -> [B, Hkv, S*G, D], row = tok * G + g."""
    b, s, hq, d = x.shape
    return x.reshape(b, s, hkv, hq // hkv, d).permute(0, 2, 1, 3, 4).reshape(
        b, hkv, s * (hq // hkv), d)


def unpack_q(x: torch.Tensor, s: int) -> torch.Tensor:
    """[B, Hkv, S*G, D] -> [B, S, Hkv*G, D]."""
    b, hkv, rows, d = x.shape
    g = rows // s
    return x.reshape(b, hkv, s, g, d).permute(0, 2, 1, 3, 4).reshape(
        b, s, hkv * g, d)


def flash_forward(qp: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor, *,
                  group: int, causal: bool, scale: float, q_offset: int,
                  kv_len: torch.Tensor | None = None):
    """qp [B, Hkv, S*G, Dk], kp [B, Hkv, Skv, Dk], vp [B, Hkv, Skv, Dv] ->
    (o [B, Hkv, S*G, Dv] in qp's dtype, lse [B, Hkv, S*G] f32) through the
    kernel wrapper; kv_len [B] (optional) masks keys >= kv_len[b]."""
    b, hkv, rows, d = qp.shape
    skv, dv = kp.shape[2], vp.shape[3]
    bq = pick_block_q(rows // group, group)
    nq = rows // (bq * group)
    if kv_len is not None:  # one length per (b, KV head) slice
        kv_len = kv_len.to(torch.int32).repeat_interleave(hkv).contiguous()
    o, lse = K.flash_attention_fwd(
        qp.reshape(b * hkv, nq, bq * group, d).contiguous(),
        kp.reshape(b * hkv, skv, d).contiguous(),
        vp.reshape(b * hkv, skv, dv).contiguous(),
        block_q=bq, group=group, scale=scale, causal=causal,
        q_offset=q_offset, kv_len=kv_len)
    return o.reshape(b, hkv, rows, dv), lse.reshape(b, hkv, rows)


def flash_backward(qp, kp, vp, op, lse, dop, *, group: int, causal: bool,
                   scale: float, q_offset: int, kv_block: int = BWD_KV_BLOCK):
    """`ref._flash_vjp_bwd` on the packed layout: (dq, dk, dv) with the
    shapes and dtypes of (qp, kp, vp)."""
    rows = qp.shape[2]
    skv = kp.shape[2]
    dev = qp.device
    qf, dof = qp.float(), dop.float()
    delta = torch.sum(dof * op.float(), dim=-1)  # [B, Hkv, rows]
    lse_safe = torch.where(lse <= NEG_INF, 0.0, lse)
    q_pos = q_offset + torch.arange(rows, device=dev) // group
    dq = torch.zeros(qf.shape, dtype=torch.float32, device=dev)
    dk = torch.zeros(kp.shape, dtype=torch.float32, device=dev)
    dv = torch.zeros(vp.shape, dtype=torch.float32, device=dev)
    for k0 in range(0, skv, kv_block):
        k1 = min(k0 + kv_block, skv)
        r0 = min(max(k0 - q_offset, 0), rows // group) * group if causal else 0
        if r0 >= rows:
            break  # this block and every later one lie above the diagonal
        kc = kp[:, :, k0:k1].float()
        vc = vp[:, :, k0:k1].float()
        qs, dos = qf[:, :, r0:], dof[:, :, r0:]
        s = torch.matmul(qs, kc.transpose(-1, -2)) * scale
        p = torch.exp(s - lse_safe[:, :, r0:, None])
        if causal:
            kv_pos = torch.arange(k0, k1, device=dev)
            p = torch.where(kv_pos[None, :] <= q_pos[r0:, None], p, 0.0)
        dp = torch.matmul(dos, vc.transpose(-1, -2))
        ds = p * (dp - delta[:, :, r0:, None]) * scale
        dq[:, :, r0:] += torch.matmul(ds, kc)
        dk[:, :, k0:k1] = torch.matmul(ds.transpose(-1, -2), qs)
        dv[:, :, k0:k1] = torch.matmul(p.transpose(-1, -2), dos)
    return dq.to(qp.dtype), dk.to(kp.dtype), dv.to(vp.dtype)


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, q_offset: int,
                kv_len=None):
        b, sq, hq, _ = q.shape
        hkv = k.shape[2]
        qp = pack_q(q, hkv)
        kp = k.permute(0, 2, 1, 3).contiguous()
        vp = v.permute(0, 2, 1, 3).contiguous()
        op, lse = flash_forward(qp, kp, vp, group=hq // hkv, causal=causal,
                                scale=scale, q_offset=q_offset, kv_len=kv_len)
        ctx.save_for_backward(qp, kp, vp, op, lse)
        ctx.cfg = (hq // hkv, causal, scale, q_offset, sq)
        ctx.forward_only = kv_len is not None or v.shape[3] != k.shape[3]
        return unpack_q(op, sq)

    @staticmethod
    def backward(ctx, do):
        if ctx.forward_only:
            raise NotImplementedError(
                "flash_attention: the backward of a kv_len-masked or "
                "mixed-width (MLA) forward is not ported yet")
        qp, kp, vp, op, lse = ctx.saved_tensors
        group, causal, scale, q_offset, sq = ctx.cfg
        dq, dk, dv = flash_backward(
            qp, kp, vp, op, lse, pack_q(do, kp.shape[1]), group=group,
            causal=causal, scale=scale, q_offset=q_offset)
        return (unpack_q(dq, sq), dk.permute(0, 2, 1, 3),
                dv.permute(0, 2, 1, 3), None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    q_offset: int = 0,
                    kv_len: torch.Tensor | None = None) -> torch.Tensor:
    """Causal (or bidirectional) GQA flash attention.  q [B, Sq, Hq, Dk];
    k [B, Skv, Hkv, Dk] and v [B, Skv, Hkv, Dv] with Hq a multiple of Hkv;
    query row i sits at position q_offset + i; kv_len [B] (optional)
    masks the keys at or past each batch row's length.  Returns [B, Sq,
    Hq, Dv] in q's dtype."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 \
            or v.shape[:3] != k.shape[:3] \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} must be "
                         "[B, Sq, Hkv*G, Dk], [B, Skv, Hkv, Dk] and "
                         "[B, Skv, Hkv, Dv]")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return FlashAttention.apply(q, k, v, causal, scale, q_offset, kv_len)
