"""The recurrent blocks in their serving modes: Mamba2 (the hybrid
family, zamba2) and the xLSTM pair mLSTM + sLSTM (the ssm family,
xlstm).

Port of `repro/models/ssm_blocks.py` (`mamba2_block`, `mlstm_block`,
`slstm_block` and their cache specs).  The blocks keep a *state cache*
instead of KV pages, one row per slot.  Ragged and dead positions are
neutralised through the gates, which leaves the state exactly unchanged
(the SSM analog of the paged kernels' static-grid masking): dt = 0 for
Mamba2, ig = -30 / fg = +30 for the mLSTM, and a `where` that keeps the
old state for the sLSTM.

Prefill runs the chunked scans on the CUDA kernels (`kernels/mamba2/ops.py:
mamba2_ssd`, `kernels/mlstm/ops.py:mlstm_chunked`); the one-token decode
steps and the sLSTM's per-token recurrence run in PyTorch ops, as the
reference runs them outside any Pallas kernel.

Training is each block's `forward_train(u)`, the reference's mode
"train": the conv from a zero state, no mask, the scan chunk of
`prefill_chunk`, the scans from the zero state through the trainable
Functions (`mamba2_ssd_trainable`, `mlstm_trainable`: the kernel forward,
the recompute backward), the sLSTM's per-token loop from (0, 0, 0, -inf)
with every step in the autograd graph.  The serving `forward` refuses
mode "train", so a serving call cannot reach a training form.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.kernels.mamba2 import ops as m2
from repro_torch.kernels.mlstm import ops as mlk
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


def _check_mode(mode: str, cfg: ModelConfig) -> None:
    """The serving modes; training goes through `forward_train`."""
    if mode == "train":
        raise NotImplementedError(
            f"training of the {cfg.family} blocks runs through "
            f"forward_train, not the serving forward")
    if mode not in ("prefill", "decode"):
        raise ValueError(mode)


def prefill_chunk(cfg: ModelConfig, slen: int) -> int:
    """The scan chunk of an S-token prefill (SSD and mLSTM): min(chunk,
    S), halved until it divides S."""
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

    def _project(self, u: torch.Tensor, conv_state, seq_lens):
        """in_proj, the causal conv from `conv_state` (None: zeros), SiLU
        and the split: (z, x [B, S, H, P], B / C [B, S, G, N], dt [B, S,
        H] fp32 softplus'd, the new conv state)."""
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
        return z, x, bmat, cmat, dt, new_conv

    def _out(self, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """The gated RMSNorm and out_proj of the scan's y [B, S, H, P]."""
        b, slen = z.shape[:2]
        y = y.reshape(b, slen, -1)
        # the reference's site; training these blocks on a mesh waits for
        # the next slice (apply_train refuses it), so without rules this is
        # the identity
        return constrain(self.out_proj(self.norm(y * F.silu(z))), "batch",
                         "seq_sp", "embed")

    def forward(self, u: torch.Tensor, *, mode: str, conv_state: torch.Tensor,
                ssm_state: torch.Tensor, valid: torch.Tensor | None = None,
                seq_lens: torch.Tensor | None = None):
        """u [B, S, d]; conv_state [B, K-1, conv_dim]; ssm_state [B, H, N, P]
        fp32; valid [B, S] bool; seq_lens [B].  Mode "prefill" (S tokens
        from the given state) or "decode" (S = 1).  Returns (out [B, S, d],
        new conv state, new ssm state)."""
        _check_mode(mode, self.cfg)
        slen = u.shape[1]
        z, x, bmat, cmat, dt, new_conv = self._project(u, conv_state,
                                                       seq_lens)
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
        return self._out(y, z), new_conv, new_ssm

    def forward_train(self, u: torch.Tensor) -> torch.Tensor:
        """The reference's mode "train": u [B, S, d] from the zero conv and
        SSD states, the SSD through `mamba2_ssd_trainable`.  Returns out
        [B, S, d]."""
        z, x, bmat, cmat, dt, _ = self._project(u, None, None)
        y = m2.mamba2_ssd_trainable(
            x, dt, -torch.exp(self.a_log), bmat, cmat, self.d_skip,
            chunk=prefill_chunk(self.cfg, u.shape[1]))
        return self._out(y, z)


# ---------------------------------------------------------------------------
# xLSTM blocks
# ---------------------------------------------------------------------------


def xlstm_inner(cfg: ModelConfig) -> int:
    """The mLSTM's d_inner = expand * d_model = heads x head_dim."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    if s.num_heads * s.head_dim != d_inner:
        raise ValueError(f"ssm heads x head_dim != d_inner ({s}, {d_inner})")
    return d_inner


def mlstm_cache_specs(cfg: ModelConfig, batch: int) \
        -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """{'conv': [B, K-1, d_inner] param dtype, 'c': [B, H, P, P], 'n':
    [B, H, P], 'm': [B, H] fp32}."""
    s = cfg.ssm
    f32 = torch.float32
    return {"conv": ((batch, s.conv_kernel - 1, xlstm_inner(cfg)),
                     cfg.param_dtype),
            "c": ((batch, s.num_heads, s.head_dim, s.head_dim), f32),
            "n": ((batch, s.num_heads, s.head_dim), f32),
            "m": ((batch, s.num_heads), f32)}


def slstm_cache_specs(cfg: ModelConfig, batch: int) \
        -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """{'h', 'c', 'n', 'm'}: each [B, d_model] fp32."""
    return {k: ((batch, cfg.d_model), torch.float32)
            for k in ("h", "c", "n", "m")}


class MLSTMBlock(nn.Module):
    """in_proj -> (x_in, z); causal depthwise conv of x_in -> SiLU ->
    x_conv; q, k from x_conv and v from x_in; the input / forget gates
    from x_conv in fp32 (`w_gates`, fp32 with a bias) -> the chunked
    mLSTM -> RMSNorm(h) * SiLU(z) -> out_proj."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        s = cfg.ssm
        dt = cfg.param_dtype
        d_inner = xlstm_inner(cfg)
        self.cfg = cfg
        self.in_proj = L.Linear(cfg.d_model, 2 * d_inner, dtype=dt,
                                device=device)
        self.conv_w = nn.Parameter(
            torch.empty(s.conv_kernel, d_inner, dtype=dt, device=device),
            requires_grad=False)
        self.wq = L.Linear(d_inner, d_inner, dtype=dt, device=device)
        self.wk = L.Linear(d_inner, d_inner, dtype=dt, device=device)
        self.wv = L.Linear(d_inner, d_inner, dtype=dt, device=device)
        self.w_gates = L.Linear(d_inner, 2 * s.num_heads, bias=True,
                                dtype=torch.float32, device=device)
        self.norm = L.RMSNorm(d_inner, eps=cfg.norm_eps, dtype=dt,
                              device=device)
        self.out_proj = L.Linear(d_inner, cfg.d_model, dtype=dt,
                                 device=device)

    def _project(self, u: torch.Tensor, conv_state, seq_lens):
        """in_proj, the causal conv of x_in from `conv_state` (None:
        zeros), SiLU, q / k / v [B, S, H, P] and the gate preactivations
        [B, S, H] fp32: (z, q, k, v, ig, fg, the new conv state)."""
        s = self.cfg.ssm
        b, slen, _ = u.shape
        d_inner = xlstm_inner(self.cfg)
        xz = self.in_proj(u)
        x_in, z = xz[..., :d_inner], xz[..., d_inner:]
        x_conv, new_conv = L.causal_conv1d(x_in, self.conv_w, conv_state,
                                           seq_lens=seq_lens)
        x_conv = F.silu(x_conv)

        def heads(t):
            return t.reshape(b, slen, s.num_heads, s.head_dim)

        q = heads(self.wq(x_conv))
        k = heads(self.wk(x_conv))
        v = heads(self.wv(x_in))
        gates = self.w_gates(x_conv.float())
        ig, fg = gates[..., :s.num_heads], gates[..., s.num_heads:]
        return z, q, k, v, ig, fg, new_conv

    def _out(self, h: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """RMSNorm(h) * SiLU(z) and out_proj of h [B, S, H, P]."""
        b, slen = z.shape[:2]
        h = h.reshape(b, slen, -1).to(z.dtype)
        return constrain(self.out_proj(self.norm(h) * F.silu(z)), "batch",
                         "seq_sp", "embed")

    def forward(self, u: torch.Tensor, *, mode: str,
                cache: dict[str, torch.Tensor],
                valid: torch.Tensor | None = None,
                seq_lens: torch.Tensor | None = None):
        """u [B, S, d]; cache {'conv', 'c', 'n', 'm'} (`mlstm_cache_specs`);
        valid [B, S] bool; seq_lens [B].  Mode "prefill" (S tokens from
        the given state) or "decode" (S = 1).  Returns (out [B, S, d], the
        new cache)."""
        _check_mode(mode, self.cfg)
        slen = u.shape[1]
        z, q, k, v, ig, fg, new_conv = self._project(u, cache["conv"],
                                                     seq_lens)
        if valid is not None:  # state-neutral padding: f -> 1, i -> 0
            ig = torch.where(valid[..., None], ig, -30.0)
            fg = torch.where(valid[..., None], fg, 30.0)
        state = (cache["c"], cache["n"], cache["m"])
        if mode == "prefill":
            h, (c, n, m) = mlk.mlstm_chunked(
                q, k, v, ig, fg, chunk=prefill_chunk(self.cfg, slen),
                initial_state=state)
        else:
            h, (c, n, m) = mlk.decode_step(q[:, 0], k[:, 0], v[:, 0],
                                           ig[:, 0], fg[:, 0], state)
            h = h[:, None]
        return self._out(h, z), {"conv": new_conv, "c": c, "n": n, "m": m}

    def forward_train(self, u: torch.Tensor) -> torch.Tensor:
        """The reference's mode "train": u [B, S, d] from the zero conv
        state and the empty memory, the mLSTM through `mlstm_trainable`.
        Returns out [B, S, d]."""
        z, q, k, v, ig, fg, _ = self._project(u, None, None)
        h = mlk.mlstm_trainable(q, k, v, ig, fg,
                                chunk=prefill_chunk(self.cfg, u.shape[1]))
        return self._out(h, z)


def _slstm_cell(x_pre: torch.Tensor, r: torch.Tensor, state, nh: int):
    """One sLSTM step.  x_pre [B, 4, d] fp32 input preactivations; r
    [4, nh, d/nh, d/nh] fp32 block-diagonal recurrent weights; state
    (h, c, n, m) each [B, d] fp32."""
    h_prev, c_prev, n_prev, m_prev = state
    b, d = h_prev.shape
    hh = h_prev.reshape(b, nh, d // nh)
    rec = torch.einsum("bhp,ghpq->bghq", hh, r).reshape(b, 4, d)
    pre = x_pre + rec
    z_t = torch.tanh(pre[:, 0])
    i_t = pre[:, 1]
    f_t = pre[:, 2]
    o_t = torch.sigmoid(pre[:, 3])
    lf = F.logsigmoid(f_t)
    m_new = torch.maximum(lf + m_prev, i_t)
    ip = torch.exp(i_t - m_new)
    fp = torch.exp(lf + m_prev - m_new)
    c_new = fp * c_prev + ip * z_t
    n_new = fp * n_prev + ip
    h_new = o_t * c_new / torch.clamp(n_new, min=1e-6)
    return h_new, c_new, n_new, m_new


class SLSTMBlock(nn.Module):
    """w_in -> the per-token sLSTM recurrence with block-diagonal
    recurrent weights `r` [4, H, d/H, d/H] -> RMSNorm -> up -> GELU (tanh
    form, `jax.nn.gelu`'s default) gated -> down."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        s = cfg.ssm
        dt = cfg.param_dtype
        d = cfg.d_model
        self.cfg = cfg
        self.w_in = L.Linear(d, 4 * d, bias=True, dtype=dt, device=device)
        self.r = nn.Parameter(
            torch.empty(4, s.num_heads, d // s.num_heads, d // s.num_heads,
                        dtype=dt, device=device), requires_grad=False)
        self.norm = L.RMSNorm(d, eps=cfg.norm_eps, dtype=dt, device=device)
        self.up = L.Linear(d, 2 * d, dtype=dt, device=device)
        self.down = L.Linear(d, cfg.d_model, dtype=dt, device=device)

    def _out(self, hs: list[torch.Tensor], dtype) -> torch.Tensor:
        """The per-token h [B, d] stacked -> RMSNorm -> up -> gated GELU ->
        down."""
        y = self.norm(torch.stack(hs, 1).to(dtype))
        gu = self.up(y)
        d = gu.shape[-1] // 2
        return constrain(self.down(F.gelu(gu[..., :d], approximate="tanh")
                                   * gu[..., d:]), "batch", "seq_sp",
                         "embed")

    def _scan(self, u: torch.Tensor, st, valid=None):
        """The per-token recurrence of u [B, S, d] from st = (h, c, n, m)
        each [B, d] fp32, then the output layers.  Where `valid` [B, S]
        is False a row's four state leaves stay as they were.  Returns
        (out [B, S, d], the final state)."""
        b, slen, d = u.shape
        nh = self.cfg.ssm.num_heads
        x_pre = self.w_in(u).float().reshape(b, slen, 4, d)
        r = self.r.float()
        hs = []
        for t in range(slen):
            new = _slstm_cell(x_pre[:, t], r, st, nh)
            if valid is not None:
                keep = valid[:, t, None]
                new = tuple(torch.where(keep, nv, ov)
                            for nv, ov in zip(new, st))
            st = new
            hs.append(st[0])
        return self._out(hs, u.dtype), st

    def forward(self, u: torch.Tensor, *, mode: str,
                cache: dict[str, torch.Tensor],
                valid: torch.Tensor | None = None):
        """u [B, S, d]; cache {'h', 'c', 'n', 'm'} each [B, d] fp32; valid
        [B, S] bool.  A step where a row is not valid leaves all four
        state leaves of that row untouched.  Returns (out [B, S, d], the
        new cache)."""
        _check_mode(mode, self.cfg)
        if valid is None:
            valid = torch.ones(u.shape[:2], dtype=torch.bool,
                               device=u.device)
        out, st = self._scan(u, tuple(cache[k] for k in ("h", "c", "n", "m")),
                             valid)
        return out, dict(zip(("h", "c", "n", "m"), st))

    def forward_train(self, u: torch.Tensor) -> torch.Tensor:
        """The reference's mode "train": u [B, S, d] through the per-token
        recurrence from (h, c, n, m) = (0, 0, 0, -inf), every step kept in
        the autograd graph.  Returns out [B, S, d]."""
        zeros = torch.zeros((u.shape[0], u.shape[2]), dtype=torch.float32,
                            device=u.device)
        return self._scan(u, (zeros, zeros, zeros,
                              torch.full_like(zeros, -torch.inf)))[0]
