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

On a mesh (`sharding.use_rules`: training, and the dry run's serving
cells) each block computes on this rank's block of its heads where the
rules split them (the head count divides 'model'), else on all of them,
and returns the residual stream's layout (the reference constrains only
the blocks' outputs, `constrain(out, "batch", "seq_sp", "embed")`):

  Mamba2  in_proj's packed output [z | x | B | C | dt] does not split on
          head boundaries, so the rank takes its heads' columns of z, x
          and dt and every column of B and C from the gathered weight
          (`Linear.columns`), convolves its x channels and all of B / C,
          runs the SSD on its heads and its block of the SSD state, and
          closes with the gated RMSNorm (its sum of squares all-reduced
          over the heads' axes) and the row-parallel out_proj; the conv
          state stays whole (its x channels all-gathered);
  mLSTM   q / k / v read every channel of x_conv / x_in, which stay whole;
          the rank projects its heads' columns of wq / wk / wv and of the
          gates, runs the chunked mLSTM on its heads and its block of (C,
          n, m), then the split RMSNorm, the gate and the row-parallel
          out_proj;
  sLSTM   the rank's heads' columns of the four gates of w_in and its
          heads of the block-diagonal recurrent weights `r`; the per-token
          recurrence on its block of (h, c, n, m); h all-gathered before
          the output layers, which run whole.  The serving cache splits the
          sLSTM state on d wherever d divides 'model' (the reference's
          cache spec); where the heads do not split, a rank gathers its
          state whole and writes back its block.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.paged.kv_cache import ShardingError
from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import resolve
from repro_torch.kernels.mamba2 import ops as m2
from repro_torch.kernels.mlstm import ops as mlk
from repro_torch.models import layers as L
from repro_torch.models.attention import residual


def rank_heads(cfg: ModelConfig) -> tuple:
    """(the mesh axes a block's `ssm.num_heads` heads are split over under
    the active rules, or None; this rank's heads [lo, hi): all of them
    without rules)."""
    h = cfg.ssm.num_heads
    held = resolve((h,), "heads")[0]
    return held, *spmd.rank_range(h, held)


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
        """in_proj, the causal conv from `conv_state` (None: zeros; the
        whole [B, K-1, conv_dim] state), SiLU and the split of this rank's
        heads (all of them without a mesh): (z, x [B, S, h, P], B / C
        [B, S, g, N] of the groups its heads read, dt [B, S, h] fp32
        softplus'd, the new whole conv state)."""
        s = self.cfg.ssm
        b, slen, _ = u.shape
        d_inner, conv_dim = mamba2_dims(self.cfg)
        gn = s.num_groups * s.state_dim
        p = s.head_dim
        held, lo, hi = rank_heads(self.cfg)
        xw = (hi - lo) * p
        conv_w = spmd.full(self.conv_w)
        if held is None:  # [z | x | B | C | dt]
            zxbcdt = self.in_proj(u)
            z = zxbcdt[..., :d_inner]
            xbc = zxbcdt[..., d_inner:d_inner + conv_dim]
            dt = zxbcdt[..., -s.num_heads:]
        else:  # this rank's z, x and dt columns, every B / C column
            z, x, bc, dt = self.in_proj.columns(u, (
                (lo * p, hi * p), (d_inner + lo * p, d_inner + hi * p),
                (2 * d_inner, 2 * d_inner + 2 * gn),
                (2 * d_inner + 2 * gn + lo, 2 * d_inner + 2 * gn + hi)))
            xbc = torch.cat([x, bc], dim=-1)
            conv_w = torch.cat([conv_w[:, lo * p:hi * p],
                                conv_w[:, d_inner:]], dim=1)
            if conv_state is not None:
                conv_state = torch.cat([conv_state[..., lo * p:hi * p],
                                        conv_state[..., d_inner:]], dim=-1)
        xbc, new_conv = L.causal_conv1d(xbc, conv_w, conv_state,
                                        seq_lens=seq_lens)
        if held is not None and conv_state is not None:  # whole again
            new_conv = torch.cat([spmd.all_gather(new_conv[..., :xw], 2,
                                                  held),
                                  new_conv[..., xw:]], dim=-1)
        xbc = F.silu(xbc)
        x = xbc[..., :xw].reshape(b, slen, hi - lo, p)
        bmat = xbc[..., xw:xw + gn].reshape(b, slen, s.num_groups,
                                            s.state_dim)
        cmat = xbc[..., xw + gn:].reshape(b, slen, s.num_groups,
                                          s.state_dim)
        if held is not None and s.num_groups > 1:  # its heads' groups
            per = s.num_heads // s.num_groups
            glo, ghi = lo // per, (hi - 1) // per + 1
            if ghi - glo > 1 and (lo % per or (hi - lo) % per):
                raise ShardingError(
                    f"SSD heads [{lo}, {hi}) do not cover whole groups of "
                    f"{per} heads")
            bmat, cmat = bmat[:, :, glo:ghi], cmat[:, :, glo:ghi]
        dt = F.softplus(dt.float()
                        + spmd.local_block(self.dt_bias, 0, lo, hi))
        return z, x, bmat, cmat, dt, new_conv

    def _coeffs(self):
        """(A = -exp(a_log), d_skip) of this rank's heads."""
        _, lo, hi = rank_heads(self.cfg)
        return (-torch.exp(spmd.local_block(self.a_log, 0, lo, hi)),
                spmd.local_block(self.d_skip, 0, lo, hi))

    def _out(self, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """The gated RMSNorm and out_proj of the scan's y [B, S, h, P], at
        the residual stream's layout."""
        b, slen = z.shape[:2]
        held, lo, hi = rank_heads(self.cfg)
        g = y.reshape(b, slen, -1) * F.silu(z)
        if held is None:
            return residual(self.out_proj(self.norm(g)), False)
        p = self.cfg.ssm.head_dim
        g = L.rms_norm_split(
            g, spmd.local_block(self.norm.scale, 0, lo * p, hi * p),
            self.norm.eps, held, mamba2_dims(self.cfg)[0])
        return residual(g @ spmd.local_block(self.out_proj.w, 0, lo * p,
                                             hi * p), True)

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
        a, d_skip = self._coeffs()

        if mode == "prefill":
            y, new_ssm = m2.mamba2_ssd(
                x, dt, a, bmat, cmat, d_skip,
                chunk=prefill_chunk(self.cfg, slen), initial_state=ssm_state)
        else:
            y, new_ssm = m2.decode_step(x[:, 0], dt[:, 0], a, bmat[:, 0],
                                        cmat[:, 0], d_skip, ssm_state)
            y = y[:, None]
        return self._out(y, z), new_conv, new_ssm

    def forward_train(self, u: torch.Tensor) -> torch.Tensor:
        """The reference's mode "train": u [B, S, d] from the zero conv and
        SSD states, the SSD through `mamba2_ssd_trainable`.  Returns out
        [B, S, d]."""
        z, x, bmat, cmat, dt, _ = self._project(u, None, None)
        a, d_skip = self._coeffs()
        y = m2.mamba2_ssd_trainable(
            x, dt, a, bmat, cmat, d_skip,
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
        zeros), SiLU, q / k / v [B, S, h, P] and the gate preactivations
        [B, S, h] fp32 of this rank's heads (all of them without a mesh):
        (z, q, k, v, ig, fg, the new conv state).  x_in and x_conv are
        whole: every head reads every channel."""
        s = self.cfg.ssm
        b, slen, _ = u.shape
        d_inner = xlstm_inner(self.cfg)
        _, lo, hi = rank_heads(self.cfg)
        p, nh = s.head_dim, s.num_heads
        x_in, z = self.in_proj.columns(
            u, ((0, d_inner), (d_inner + lo * p, d_inner + hi * p)))
        x_conv, new_conv = L.causal_conv1d(x_in, spmd.full(self.conv_w),
                                           conv_state, seq_lens=seq_lens)
        x_conv = F.silu(x_conv)

        def heads(t):
            return t.reshape(b, slen, hi - lo, p)

        q = heads(self.wq.block(x_conv, lo * p, hi * p))
        k = heads(self.wk.block(x_conv, lo * p, hi * p))
        v = heads(self.wv.block(x_in, lo * p, hi * p))
        ig, fg = self.w_gates.columns(x_conv.float(),
                                      ((lo, hi), (nh + lo, nh + hi)))
        return z, q, k, v, ig, fg, new_conv

    def _out(self, h: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """RMSNorm(h) * SiLU(z) and out_proj of h [B, S, h, P], at the
        residual stream's layout."""
        b, slen = z.shape[:2]
        h = h.reshape(b, slen, -1).to(z.dtype)
        held, lo, hi = rank_heads(self.cfg)
        if held is None:
            return residual(self.out_proj(self.norm(h) * F.silu(z)), False)
        p = self.cfg.ssm.head_dim
        g = L.rms_norm_split(
            h, spmd.local_block(self.norm.scale, 0, lo * p, hi * p),
            self.norm.eps, held, xlstm_inner(self.cfg)) * F.silu(z)
        return residual(g @ spmd.local_block(self.out_proj.w, 0, lo * p,
                                             hi * p), True)

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
        """The per-token h [B, d] (this rank's heads' block of d under
        split heads, all-gathered) stacked -> RMSNorm -> up -> gated GELU
        -> down, at the residual stream's layout."""
        held = rank_heads(self.cfg)[0]
        y = torch.stack(hs, 1).to(dtype)
        if held is not None:
            y = spmd.all_gather(y, 2, held)
        y = self.norm(y)
        gu = self.up(y)
        d = gu.shape[-1] // 2
        return residual(self.down(F.gelu(gu[..., :d], approximate="tanh")
                                  * gu[..., d:]), False)

    def _scan(self, u: torch.Tensor, st, valid=None):
        """The per-token recurrence of u [B, S, d] from st = (h, c, n, m)
        each [B, d'] fp32 (d' the block of d of this rank's heads: d
        without a mesh), then the output layers.  Where `valid` [B, S] is
        False a row's four state leaves stay as they were.  Returns (out
        [B, S, d], the final state)."""
        b, slen, d = u.shape
        held, lo, hi = rank_heads(self.cfg)
        dh = d // self.cfg.ssm.num_heads
        if held is None:
            x_pre = self.w_in(u).float().reshape(b, slen, 4, d)
        else:  # the four gates' columns of this rank's heads
            x_pre = torch.stack(self.w_in.columns(u, tuple(
                (g * d + lo * dh, g * d + hi * dh) for g in range(4))),
                2).float()
        r = spmd.local_block(self.r, 1, lo, hi).float()
        hs = []
        for t in range(slen):
            new = _slstm_cell(x_pre[:, t], r, st, hi - lo)
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
        """u [B, S, d]; cache {'h', 'c', 'n', 'm'} each [B, d] fp32 (on a
        mesh the rank's block of d the cache spec gives it); valid [B, S]
        bool.  A step where a row is not valid leaves all four state
        leaves of that row untouched.  Returns (out [B, S, d], the new
        cache)."""
        _check_mode(mode, self.cfg)
        if valid is None:
            valid = torch.ones(u.shape[:2], dtype=torch.bool,
                               device=u.device)
        d = u.shape[2]
        _, lo, hi = rank_heads(self.cfg)
        dh = d // self.cfg.ssm.num_heads
        st = tuple(cache[k] for k in ("h", "c", "n", "m"))
        held_c = None  # the cache's block of d, where it is not the heads'
        if st[0].shape[1] != (hi - lo) * dh:
            held_c = ("model",)
            st = tuple(spmd.all_gather(t, 1, held_c) for t in st)
        out, st = self._scan(u, st, valid)
        if held_c is not None:
            clo, chi = spmd.rank_range(d, held_c)
            st = tuple(t[:, clo:chi] for t in st)
        return out, dict(zip(("h", "c", "n", "m"), st))

    def forward_train(self, u: torch.Tensor) -> torch.Tensor:
        """The reference's mode "train": u [B, S, d] through the per-token
        recurrence from (h, c, n, m) = (0, 0, 0, -inf) (this rank's heads'
        block of each), every step kept in the autograd graph.  Returns
        out [B, S, d] at the residual stream's layout."""
        _, lo, hi = rank_heads(self.cfg)
        width = (hi - lo) * (u.shape[2] // self.cfg.ssm.num_heads)
        zeros = torch.zeros((u.shape[0], width), dtype=torch.float32,
                            device=u.device)
        return self._scan(u, (zeros, zeros, zeros,
                              torch.full_like(zeros, -torch.inf)))[0]
