"""GQA attention: the unified (token-packed) serving mode and the padded
prefill / decode modes over the paged KV cache, and the dense causal
training mode.

Unified step: QKV projections, packed-position RoPE (each token rotates by
its own absolute position), the KV page write at the host-computed
`slot_mapping` (in place; padded tokens aim at the out-of-range trash slot
and are dropped), one unified attention launch over decode rows and
prefill chunks, then `wo`.  Padded prefill ([B, S], context 0) and decode
([B, 1]): the same write at slots from `kv_cache.physical_slots`, then the
Q-Block prefill or the C1-C3 decode kernels.  The reference computes those
slots in every layer; the port computes them once per step (the write
index `write_index` in `meta`, `kv_cache.write_index`), since every
layer writes the same positions.  Resumed prefill ([B, S] chunks at
absolute positions after a prior context in the pages): the same write,
then the Q-Block prefill over the whole paged context.  Training: QKV,
RoPE, causal flash attention over the whole sequence (no cache), then
`wo`.

MLA (deepseek-v2, `MLAAttention`) serves on the padded step only, as in
the reference: it caches one compressed row [latent | k_rope] a token
(one "KV head", no V pages).  Prefill runs the expanded form (per-head
keys [wk_b . latent | k_rope] and values wv_b . latent through the flash
forward at key width nope + rope, value width v, keys masked at each
row's query length); decode the absorbed form (q_nope . wk_b in fp32,
the latent decode kernel over the pages with V the latent prefix of each
row, then . wv_b in fp32).  Training runs the prefill's expanded form
without the cache write or the length mask.

Tensor parallelism (`shard`, a `distributed.sharding.ShardCtx` of size
> 1; the unified step only, the reference's `_local_heads` and its one
collective): q / k / v keep this rank's Hq / tp and Hkv / tp heads (the
`wq` / `wk` / `wv` leaves already cut to them by
`param_sharding.shard_serve_params`, or the rank's block sliced out of a
replicated fused `wqkv`'s projection), the KV write and the unified
attention run on the rank's pool of Hkv / tp heads, and one all-gather
of the attention output on the head axis reassembles the full head set
before the replicated `wo`.  Every other mode, and MLA, raises
`ShardingError` under a split.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import backend as attn_backend
from repro_torch.core.paged.kv_cache import ShardingError, scatter_kv
from repro_torch.distributed.sharding import all_gather_heads
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import layers as L


def kv_cache_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(num_kv_heads, k_dim, v_dim) of the paged cache rows; v_dim 0 means
    V is a view into K (MLA's latent)."""
    if cfg.mla.kv_lora_rank:
        return 1, cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim, 0
    dh = cfg.resolved_head_dim
    return cfg.num_kv_heads, dh, dh


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [n, i, k] @ b [n, k, j] with fp32 products and sums, as the
    reference's fp32 einsums.  bf16 operands on the card go through a bf16
    GEMM with fp32 output (a bf16 product is exact in fp32), so no fp32
    copy of a weight is made; otherwise the operands are taken in fp32."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _split(shard) -> bool:
    return shard is not None and shard.size > 1


def _local_heads(x: torch.Tensor, n_local: int, shard) -> torch.Tensor:
    """This rank's contiguous head block of a [B, S, H, D] projection: x
    itself where the projection's leaves were cut to the local heads,
    else (a replicated fused `wqkv`) block `shard.rank` of the full set.
    RoPE is per head and position, so slicing after it equals slicing
    before."""
    if x.shape[2] == n_local:
        return x
    return x[:, :, shard.rank * n_local:(shard.rank + 1) * n_local]


def _refuse_split(shard, mode: str) -> None:
    if _split(shard):
        raise ShardingError(
            f"the mesh executor only runs the packed unified step; "
            f"attention mode={mode!r} cannot run under tp={shard.size}")


def rope(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
         rotary_dim: int | None = None) -> torch.Tensor:
    """The model's position encoding of x [..., S, H, D] (the reference's
    `_rope`): RoPE over positions [..., S], M-RoPE over [3, ..., S] (t / h
    / w rows), or none."""
    if cfg.rope_style == "rope":
        return L.apply_rope(x, positions, cfg.rope_theta, rotary_dim)
    if cfg.rope_style == "mrope":
        return L.apply_mrope(x, positions, cfg.rope_theta,
                             cfg.mrope_sections)
    return x


def temporal(positions: torch.Tensor) -> torch.Tensor:
    """The in-sequence positions [..., S] behind positions [..., S] or
    M-RoPE's [3, ..., S]: its temporal row, where the KV rows are
    written (the reference's `positions[0]`)."""
    return positions[0] if positions.ndim == 3 else positions


class Attention(nn.Module):
    """GQA attention.  Leaves `wq`, `wk`, `wv` (biased where `qkv_bias`),
    `wo`; with `fused_qkv` one `wqkv` [d, (Hq + 2 Hkv) Dh] in place of the
    three, its output split at Hq Dh and (Hq + Hkv) Dh (the reference's
    `_qkv`).  Under tensor parallelism `wq` / `wk` / `wv` may hold only
    a rank's heads (`param_sharding.shard_serve_params`): the head counts
    of q / k / v follow the leaves' widths."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        dh = cfg.resolved_head_dim
        dt = cfg.param_dtype
        hq, hkv = cfg.num_q_heads, cfg.num_kv_heads
        if cfg.fused_qkv:
            self.wqkv = L.Linear(cfg.d_model, (hq + 2 * hkv) * dh,
                                 bias=cfg.qkv_bias, dtype=dt, device=device)
        else:
            self.wq = L.Linear(cfg.d_model, hq * dh, bias=cfg.qkv_bias,
                               dtype=dt, device=device)
            self.wk = L.Linear(cfg.d_model, hkv * dh, bias=cfg.qkv_bias,
                               dtype=dt, device=device)
            self.wv = L.Linear(cfg.d_model, hkv * dh, bias=cfg.qkv_bias,
                               dtype=dt, device=device)
        self.wo = L.Linear(hq * dh, cfg.d_model, dtype=dt, device=device)

    def qkv(self, x: torch.Tensor, positions: torch.Tensor):
        b, s, _ = x.shape
        cfg = self.cfg
        dh = cfg.resolved_head_dim
        hq, hkv = cfg.num_q_heads, cfg.num_kv_heads
        if cfg.fused_qkv:
            q, k, v = self.wqkv(x).split([hq * dh, hkv * dh, hkv * dh],
                                         dim=-1)
        else:
            q, k, v = self.wq(x), self.wk(x), self.wv(x)
        q = rope(cfg, q.reshape(b, s, -1, dh), positions)
        k = rope(cfg, k.reshape(b, s, -1, dh), positions)
        return q, k, v.reshape(b, s, -1, dh)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                k_pages: torch.Tensor, v_pages: torch.Tensor, meta: dict,
                kernel_cfg=None, shard=None) -> torch.Tensor:
        """x [1, T, d]; k/v_pages this layer's [Hkv, 1, P, ps, D] cache
        (written in place; under `shard` the rank's Hkv / tp heads).
        meta: page_table, context_lens, query_lens, query_start_loc,
        num_decode_seqs, and the step's write index `write_index`
        (`kv_cache.write_index` of slot_mapping).  Returns [1, T, d]."""
        b, t, _ = x.shape
        q, k, v = self.qkv(x, positions)
        if _split(shard):
            q = _local_heads(q, self.cfg.num_q_heads // shard.size, shard)
            k = _local_heads(k, self.cfg.num_kv_heads // shard.size, shard)
            v = _local_heads(v, self.cfg.num_kv_heads // shard.size, shard)
        scatter_kv(k_pages, k[0].transpose(0, 1), meta["write_index"])
        scatter_kv(v_pages, v[0].transpose(0, 1), meta["write_index"])
        o = attn_backend.unified_attention(
            q[0], k_pages, v_pages, meta["page_table"],
            meta["context_lens"], meta["query_start_loc"],
            meta["query_lens"], num_decode_seqs=meta["num_decode_seqs"],
            scale=self.cfg.resolved_head_dim ** -0.5, kernel_cfg=kernel_cfg,
        )
        if _split(shard):
            # the step's one collective: the ranks hold disjoint contiguous
            # head blocks, so gathering them in rank order gives one
            # device's o exactly
            o = all_gather_heads(o, shard)
        return self.wo(o[None].reshape(b, t, -1).to(x.dtype))

    def _write_kv(self, k, v, k_pages, v_pages, meta) -> None:
        """Write the step's K / V rows [B, S, Hkv, D] into this layer's
        pages at the step's write index (in place)."""
        hkv, d = k.shape[2], k.shape[3]
        index = meta["write_index"]
        scatter_kv(k_pages, k.reshape(-1, hkv, d).transpose(0, 1), index)
        scatter_kv(v_pages, v.reshape(-1, hkv, d).transpose(0, 1), index)

    def forward_prefill(self, x: torch.Tensor, positions: torch.Tensor,
                        k_pages: torch.Tensor, v_pages: torch.Tensor,
                        meta: dict, kernel_cfg=None,
                        shard=None) -> torch.Tensor:
        """Chunks of prompts: fresh at context 0, or resumed after a prior
        context in the pages (positions absolute, context_lens = prior +
        chunk).  x [B, S, d]; positions [B, S]; meta: page_table,
        context_lens, query_lens and the write index.  Returns [B, S, d]."""
        _refuse_split(shard, "prefill")
        b, s, _ = x.shape
        q, k, v = self.qkv(x, positions)
        self._write_kv(k, v, k_pages, v_pages, meta)
        o = attn_backend.prefill_attention_uniform(
            q, meta["query_lens"], k_pages, v_pages, meta["page_table"],
            meta["context_lens"], scale=self.cfg.resolved_head_dim ** -0.5,
            kernel_cfg=kernel_cfg)
        return self.wo(o.reshape(b, s, -1).to(x.dtype))

    def forward_decode(self, x: torch.Tensor, positions: torch.Tensor,
                       k_pages: torch.Tensor, v_pages: torch.Tensor,
                       meta: dict, kernel_cfg=None,
                       shard=None) -> torch.Tensor:
        """One token per slot.  x [B, 1, d]; positions [B, 1] (-1 on dead
        slots); meta: page_table, context_lens (0 on dead slots) and the
        write index.  Returns [B, 1, d]."""
        _refuse_split(shard, "decode")
        b = x.shape[0]
        q, k, v = self.qkv(x, positions)
        self._write_kv(k, v, k_pages, v_pages, meta)
        o = attn_backend.decode_attention(
            q[:, 0], k_pages, v_pages, meta["page_table"],
            meta["context_lens"], scale=self.cfg.resolved_head_dim ** -0.5,
            kernel_cfg=kernel_cfg)
        return self.wo(o.reshape(b, 1, -1).to(x.dtype))

    def forward_train(self, x: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
        """x [B, S, d]; positions [B, S].  Causal self-attention over the
        sequence (the reference's mode="train").  Returns [B, S, d]."""
        b, s, _ = x.shape
        q, k, v = self.qkv(x, positions)
        o = flash_attention(q, k, v, causal=True,
                            scale=self.cfg.resolved_head_dim ** -0.5)
        return self.wo(o.reshape(b, s, -1).to(x.dtype))


class MLAAttention(nn.Module):
    """deepseek-v2's multi-head latent attention (the reference's
    `_mla_attention`), for the padded serving modes and training.  Leaves: `wkv_a`,
    `kv_norm`, `wk_b`, `wv_b`, `wo`, and `wq_a` / `q_norm` / `wq_b`, or
    `wq` where `q_lora_rank` is 0.  The layer's cache is one page pool of
    [latent | k_rope] rows, k_pages [1, 1, P, ps, r + rope]."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        m = cfg.mla
        h, dt = cfg.num_q_heads, cfg.param_dtype
        qk = m.qk_nope_dim + m.qk_rope_dim
        self.q_lora = m.q_lora_rank > 0
        if self.q_lora:
            self.wq_a = L.Linear(cfg.d_model, m.q_lora_rank, dtype=dt,
                                 device=device)
            self.q_norm = L.RMSNorm(m.q_lora_rank, eps=cfg.norm_eps,
                                    dtype=dt, device=device)
            self.wq_b = L.Linear(m.q_lora_rank, h * qk, dtype=dt,
                                 device=device)
        else:
            self.wq = L.Linear(cfg.d_model, h * qk, dtype=dt, device=device)
        self.wkv_a = L.Linear(cfg.d_model, m.kv_lora_rank + m.qk_rope_dim,
                              dtype=dt, device=device)
        self.kv_norm = L.RMSNorm(m.kv_lora_rank, eps=cfg.norm_eps, dtype=dt,
                                 device=device)
        self.wk_b = L.Linear(m.kv_lora_rank, h * m.qk_nope_dim, dtype=dt,
                             device=device)
        self.wv_b = L.Linear(m.kv_lora_rank, h * m.v_head_dim, dtype=dt,
                             device=device)
        self.wo = L.Linear(h * m.v_head_dim, cfg.d_model, dtype=dt,
                           device=device)
        self.scale = qk ** -0.5

    def q(self, x: torch.Tensor, positions: torch.Tensor):
        """(q_nope [B, S, H, nope], q_rope [B, S, H, rope] rotated): the
        reference's `_mla_q`."""
        b, s, _ = x.shape
        m = self.cfg.mla
        q = self.wq_b(self.q_norm(self.wq_a(x))) if self.q_lora \
            else self.wq(x)
        q = q.reshape(b, s, self.cfg.num_q_heads,
                      m.qk_nope_dim + m.qk_rope_dim)
        q_rope = rope(self.cfg, q[..., m.qk_nope_dim:], positions)
        return q[..., :m.qk_nope_dim], q_rope

    def latent(self, x: torch.Tensor, positions: torch.Tensor):
        """(latent [B, S, r] normed, k_rope [B, S, rope] rotated): what the
        cache holds, the reference's `_mla_latent`."""
        r = self.cfg.mla.kv_lora_rank
        kv = self.wkv_a(x)
        latent = self.kv_norm(kv[..., :r])
        k_rope = rope(self.cfg, kv[..., r:][:, :, None, :],
                      positions)[:, :, 0]
        return latent, k_rope

    def _expand(self, q_nope, q_rope, latent, k_rope):
        """The expanded form's (q, k, v): per-head keys [wk_b . latent |
        k_rope broadcast over the heads] and values wv_b . latent."""
        b, s, _ = latent.shape
        m, h = self.cfg.mla, self.cfg.num_q_heads
        k_nope = self.wk_b(latent).reshape(b, s, h, m.qk_nope_dim)
        v = self.wv_b(latent).reshape(b, s, h, m.v_head_dim)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            b, s, h, m.qk_rope_dim)], dim=-1)
        return torch.cat([q_nope, q_rope], dim=-1), k, v

    def _write_rows(self, latent, k_rope, k_pages, meta) -> None:
        """The step's [latent | k_rope] rows into this layer's pages at the
        write index (in place)."""
        row = torch.cat([latent, k_rope], dim=-1)
        scatter_kv(k_pages, row.reshape(1, -1, row.shape[-1]),
                   meta["write_index"])

    def forward(self, *args, shard=None, **kwargs):
        self._refuse_split(shard)
        raise ValueError("the unified packed step is unsupported for MLA: "
                         "it serves on the padded per-kind step")

    @staticmethod
    def _refuse_split(shard) -> None:
        if _split(shard):
            raise ShardingError(
                "MLA attention has a single latent KV head and cannot be "
                f"head-sharded (requested tp={shard.size})")

    def forward_prefill(self, x: torch.Tensor, positions: torch.Tensor,
                        k_pages: torch.Tensor, v_pages, meta: dict,
                        kernel_cfg=None, shard=None) -> torch.Tensor:
        """Fresh prompts at context 0 in the expanded form.  x [B, S, d];
        positions [B, S]; k_pages [1, 1, P, ps, r + rope] (v_pages None);
        meta: query_lens and the write index.  `cfg.mla_fused_prefill`
        computes the same function (the reference's per-KV-block
        expansion keeps its score buffers small; the flash forward never
        holds one), so it takes this path too.  Returns [B, S, d]."""
        self._refuse_split(shard)
        b, s, _ = x.shape
        q_nope, q_rope = self.q(x, positions)
        latent, k_rope = self.latent(x, positions)
        self._write_rows(latent, k_rope, k_pages, meta)
        q, k, v = self._expand(q_nope, q_rope, latent, k_rope)
        o = flash_attention(q, k, v, causal=True, scale=self.scale,
                            kv_len=meta["query_lens"])
        return self.wo(o.reshape(b, s, -1).to(x.dtype))

    def forward_decode(self, x: torch.Tensor, positions: torch.Tensor,
                       k_pages: torch.Tensor, v_pages, meta: dict,
                       kernel_cfg=None, shard=None) -> torch.Tensor:
        """One token per slot in the absorbed form.  x [B, 1, d];
        positions [B, 1] (-1 on dead slots); meta: page_table,
        context_lens (0 on dead slots) and the write index.  The kernel
        config is not read: the latent decode has one path, as the
        reference's.  Returns [B, 1, d]."""
        self._refuse_split(shard)
        b = x.shape[0]
        m, h = self.cfg.mla, self.cfg.num_q_heads
        r = m.kv_lora_rank
        q_nope, q_rope = self.q(x, positions)
        latent, k_rope = self.latent(x, positions)
        self._write_rows(latent, k_rope, k_pages, meta)
        wkb = self.wk_b.w.reshape(r, h, m.qk_nope_dim).permute(1, 2, 0)
        q_abs = _bmm_f32(q_nope[:, 0].transpose(0, 1), wkb)  # [H, B, r]
        q_eff = torch.cat([q_abs.transpose(0, 1).to(x.dtype),
                           q_rope[:, 0]], dim=-1)
        o_lat = attn_backend.mla_decode_attention(
            q_eff, k_pages, meta["page_table"], meta["context_lens"],
            v_dim=r, scale=self.scale)  # [B, H, r]
        wvb = self.wv_b.w.reshape(r, h, m.v_head_dim).transpose(0, 1)
        o = _bmm_f32(o_lat.transpose(0, 1), wvb)  # [H, B, v]
        return self.wo(o.transpose(0, 1).reshape(b, 1, -1).to(x.dtype))

    def forward_train(self, x: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
        """Causal self-attention over the sequence in the expanded form
        (the reference's mode="train"): `forward_prefill` without the
        cache write or the key-length mask.  x [B, S, d]; positions
        [B, S].  Returns [B, S, d]."""
        b, s, _ = x.shape
        q_nope, q_rope = self.q(x, positions)
        latent, k_rope = self.latent(x, positions)
        q, k, v = self._expand(q_nope, q_rope, latent, k_rope)
        o = flash_attention(q, k, v, causal=True, scale=self.scale)
        return self.wo(o.reshape(b, s, -1).to(x.dtype))
