"""The Mamba2 block of the hybrid family (zamba2), in its serving modes.

Port of `repro/models/ssm_blocks.py` (`mamba2_block`,
`mamba2_cache_specs`).  The block keeps a *state cache* beside the KV
pages: per slot, the last K-1 conv inputs and the fp32 SSM state
[H, N, P].  Ragged and dead positions are neutralised through the gate,
dt = 0 where not valid, which leaves the state exactly unchanged (the SSM
analog of the paged kernels' static-grid masking).

Prefill runs the chunked SSD on the CUDA kernel (`kernels/mamba2/ops.py:
mamba2_ssd`); decode runs the one-token recurrence in PyTorch ops, as the
reference does outside any Pallas kernel.  Training of the hybrid family
is not ported: mode "train" raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba2 import ops as m2
from repro_torch.models import layers as L


def mamba2_dims(cfg: ModelConfig) -> tuple[int, int]:
    """(d_inner, conv_dim)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    if s.num_heads * s.head_dim != d_inner:
        raise ValueError(f"ssm heads x head_dim != d_inner ({s}, {d_inner})")
    return d_inner, d_inner + 2 * s.num_groups * s.state_dim


def mamba2_cache_specs(cfg: ModelConfig, batch: int) \
        -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """{'conv': ([B, K-1, conv_dim], param dtype), 'ssm': ([B, H, N, P],
    fp32)}."""
    s = cfg.ssm
    _, conv_dim = mamba2_dims(cfg)
    return {"conv": ((batch, s.conv_kernel - 1, conv_dim), cfg.param_dtype),
            "ssm": ((batch, s.num_heads, s.state_dim, s.head_dim),
                    torch.float32)}


def prefill_chunk(cfg: ModelConfig, slen: int) -> int:
    """The SSD chunk of an S-token prefill: min(chunk, S), halved until
    it divides S."""
    chunk = min(cfg.ssm.chunk, slen)
    while slen % chunk:
        chunk //= 2
    return chunk


class Mamba2Block(nn.Module):
    """in_proj -> causal depthwise conv -> SiLU -> SSD -> gated RMSNorm ->
    out_proj.  Parameters as in the reference; `a_log`, `d_skip` and
    `dt_bias` are fp32 whatever the model's dtype."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        s = cfg.ssm
        dt = cfg.param_dtype
        d_inner, conv_dim = mamba2_dims(cfg)
        in_dim = 2 * d_inner + 2 * s.num_groups * s.state_dim + s.num_heads
        self.cfg = cfg
        self.in_proj = L.Linear(cfg.d_model, in_dim, dtype=dt, device=device)
        self.conv_w = nn.Parameter(
            torch.empty(s.conv_kernel, conv_dim, dtype=dt, device=device),
            requires_grad=False)
        f32 = dict(dtype=torch.float32, device=device)
        self.a_log = nn.Parameter(torch.zeros(s.num_heads, **f32),
                                  requires_grad=False)
        self.d_skip = nn.Parameter(torch.ones(s.num_heads, **f32),
                                   requires_grad=False)
        self.dt_bias = nn.Parameter(torch.zeros(s.num_heads, **f32),
                                    requires_grad=False)
        self.norm = L.RMSNorm(d_inner, eps=cfg.norm_eps, dtype=dt,
                              device=device)
        self.out_proj = L.Linear(d_inner, cfg.d_model, dtype=dt,
                                 device=device)

    def forward(self, u: torch.Tensor, *, mode: str, conv_state: torch.Tensor,
                ssm_state: torch.Tensor, valid: torch.Tensor | None = None,
                seq_lens: torch.Tensor | None = None):
        """u [B, S, d]; conv_state [B, K-1, conv_dim]; ssm_state [B, H, N, P]
        fp32; valid [B, S] bool; seq_lens [B].  Mode "prefill" (S tokens
        from the given state) or "decode" (S = 1).  Returns (out [B, S, d],
        new conv state, new ssm state)."""
        if mode == "train":
            raise NotImplementedError(
                "training of the hybrid family is not ported yet")
        if mode not in ("prefill", "decode"):
            raise ValueError(mode)
        s = self.cfg.ssm
        b, slen, _ = u.shape
        d_inner, conv_dim = mamba2_dims(self.cfg)
        gn = s.num_groups * s.state_dim

        zxbcdt = self.in_proj(u)
        z = zxbcdt[..., :d_inner]
        xbc = zxbcdt[..., d_inner:d_inner + conv_dim]
        dt = zxbcdt[..., -s.num_heads:].float()
        xbc, new_conv = L.causal_conv1d(xbc, self.conv_w, conv_state,
                                        seq_lens=seq_lens)
        xbc = F.silu(xbc)
        x = xbc[..., :d_inner].reshape(b, slen, s.num_heads, s.head_dim)
        bmat = xbc[..., d_inner:d_inner + gn].reshape(
            b, slen, s.num_groups, s.state_dim)
        cmat = xbc[..., d_inner + gn:].reshape(b, slen, s.num_groups,
                                               s.state_dim)
        dt = F.softplus(dt + self.dt_bias)
        if valid is not None:
            dt = torch.where(valid[..., None], dt, 0.0)  # state-neutral
        a = -torch.exp(self.a_log)

        if mode == "prefill":
            y, new_ssm = m2.mamba2_ssd(
                x, dt, a, bmat, cmat, self.d_skip,
                chunk=prefill_chunk(self.cfg, slen), initial_state=ssm_state)
        else:
            y, new_ssm = m2.decode_step(x[:, 0], dt[:, 0], a, bmat[:, 0],
                                        cmat[:, 0], self.d_skip, ssm_state)
            y = y[:, None]
        y = y.reshape(b, slen, d_inner)
        y = self.norm(y * F.silu(z))
        return self.out_proj(y), new_conv, new_ssm
