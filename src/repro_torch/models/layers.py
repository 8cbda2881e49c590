"""Primitive layers as `nn.Module`s and plain functions on tensors.

Linear weights keep the JAX reference's layout, `w [d_in, d_out]` with
`y = x @ w`, so `weights.from_jax_params` copies them without a transpose.
Norms, RoPE and the output logits run in fp32, as in the reference.
"""
from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Module):
    """y = x @ w (+ b); w [d_in, d_out]."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_in, d_out, dtype=dtype,
                                          device=device), requires_grad=False)
        self.b = (nn.Parameter(torch.zeros(d_out, dtype=dtype, device=device),
                               requires_grad=False) if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w
        if self.b is not None:
            y = y + self.b
        return y


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                                  requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale, self.eps)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """table[tokens]; `F.embedding`, whose backward on the CPU is
    deterministic (indexing's accumulating backward is not), so a
    restarted training run repeats the uninterrupted one bit for bit."""
    return F.embedding(tokens.long(), table)


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Logits in fp32 (the standard loss-stability choice)."""
    return x.float() @ table.float().T


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0,
               rotary_dim: int | None = None) -> torch.Tensor:
    """x [..., S, H, D]; positions [..., S] (ints). Rotates pairs
    (x[..., :D/2], x[..., D/2:]) — the llama 'half rotation' convention."""
    d = x.shape[-1]
    rd = rotary_dim or d
    freqs = rope_frequencies(rd, theta, x.device)  # [rd/2]
    angles = positions[..., None].float() * freqs  # [..., S, rd/2]
    cos = torch.cos(angles)[..., None, :]  # [..., S, 1, rd/2]
    sin = torch.sin(angles)[..., None, :]
    xf = x.float()
    x1, x2 = xf[..., : rd // 2], xf[..., rd // 2: rd]
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if rd < d:
        rot = torch.cat([rot, xf[..., rd:]], dim=-1)
    return rot.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  x [..., S, H, D]; positions [3, ..., S]
    (t / h / w rows); `sections` split the D/2 frequency pairs across the
    three rows (pair f takes the row of the section it falls in), each
    pair rotated by the half-rotation convention of `apply_rope`."""
    d = x.shape[-1]
    assert sum(sections) == d // 2, (sections, d)
    freqs = rope_frequencies(d, theta, x.device)  # [d/2]
    # [d/2] in {0, 1, 2}: device ops on Python ints, so that a CUDA graph
    # capture makes no host-to-device copy
    pair = torch.arange(d // 2, device=x.device)
    sec_id = sum((pair >= edge).long()
                 for edge in itertools.accumulate(sections[:-1]))
    ang_all = positions[..., None].float() * freqs  # [3, ..., S, d/2]
    # the reference's one-hot contraction picks one row per pair exactly
    angles = torch.gather(ang_all, 0, sec_id.expand_as(ang_all[:1]))[0]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    xf = x.float()
    x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rot.to(x.dtype)


class MLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x)).  `fused` holds gate and up as
    one `gate_up` [d, 2 d_ff] matmul whose output splits at d_ff, gate
    first (the reference's fused layout)."""

    def __init__(self, d: int, d_ff: int, *, dtype: torch.dtype, device=None,
                 fused: bool = False):
        super().__init__()
        if fused:
            self.gate_up = Linear(d, 2 * d_ff, dtype=dtype, device=device)
        else:
            self.gate = Linear(d, d_ff, dtype=dtype, device=device)
            self.up = Linear(d, d_ff, dtype=dtype, device=device)
        self.down = Linear(d_ff, d, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "gate_up"):
            gate, up = self.gate_up(x).chunk(2, dim=-1)
            return self.down(F.silu(gate) * up)
        return self.down(F.silu(self.gate(x)) * self.up(x))


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  conv_state: torch.Tensor | None = None,
                  seq_lens: torch.Tensor | None = None):
    """Depthwise causal conv.  x [B, S, C]; w [K, C].  Returns (y, new_state
    [B, K-1, C]): the last K-1 *valid* inputs (seq_lens [B] marks the valid
    right-padded prefix; None = all S valid)."""
    k = w.shape[0]
    b, s, c = x.shape
    if conv_state is None:
        pad = torch.zeros((b, k - 1, c), dtype=x.dtype, device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # [B, S+K-1, C]
    y = xp[:, 0:s] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i]
    if k == 1:
        return y, torch.zeros((b, 0, c), dtype=x.dtype, device=x.device)
    if seq_lens is None:
        return y, xp[:, -(k - 1):]
    # token j lives at xp row (K-1)+j; the last valid token is seq_lens-1,
    # so the state rows are xp[seq_lens .. seq_lens+K-2]
    idx = seq_lens.long()[:, None] + torch.arange(k - 1, device=x.device)
    idx = torch.clamp(idx, 0, s + k - 2)
    return y, torch.gather(xp, 1, idx[..., None].expand(b, k - 1, c))
