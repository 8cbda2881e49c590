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
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import backend as attn_backend
from repro_torch.core.paged.kv_cache import scatter_kv
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import layers as L


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        if cfg.mla.kv_lora_rank:
            raise NotImplementedError("MLA attention is not ported yet")
        if cfg.fused_qkv:
            raise NotImplementedError("fused wqkv weights are not ported yet")
        if cfg.rope_style != "rope":
            raise NotImplementedError(
                f"rope_style={cfg.rope_style!r} is not ported yet")
        self.cfg = cfg
        dh = cfg.resolved_head_dim
        dt = cfg.param_dtype
        self.wq = L.Linear(cfg.d_model, cfg.num_q_heads * dh,
                           bias=cfg.qkv_bias, dtype=dt, device=device)
        self.wk = L.Linear(cfg.d_model, cfg.num_kv_heads * dh,
                           bias=cfg.qkv_bias, dtype=dt, device=device)
        self.wv = L.Linear(cfg.d_model, cfg.num_kv_heads * dh,
                           bias=cfg.qkv_bias, dtype=dt, device=device)
        self.wo = L.Linear(cfg.num_q_heads * dh, cfg.d_model, dtype=dt,
                           device=device)

    def qkv(self, x: torch.Tensor, positions: torch.Tensor):
        b, s, _ = x.shape
        cfg = self.cfg
        dh = cfg.resolved_head_dim
        q = self.wq(x).reshape(b, s, cfg.num_q_heads, dh)
        k = self.wk(x).reshape(b, s, cfg.num_kv_heads, dh)
        v = self.wv(x).reshape(b, s, cfg.num_kv_heads, dh)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        return q, k, v

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                k_pages: torch.Tensor, v_pages: torch.Tensor, meta: dict,
                kernel_cfg=None) -> torch.Tensor:
        """x [1, T, d]; k/v_pages this layer's [Hkv, 1, P, ps, D] cache
        (written in place).  meta: page_table, context_lens, query_lens,
        query_start_loc, num_decode_seqs, and the step's write index
        `write_index` (`kv_cache.write_index` of slot_mapping).  Returns [1, T, d]."""
        b, t, _ = x.shape
        q, k, v = self.qkv(x, positions)
        scatter_kv(k_pages, k[0].transpose(0, 1), meta["write_index"])
        scatter_kv(v_pages, v[0].transpose(0, 1), meta["write_index"])
        o = attn_backend.unified_attention(
            q[0], k_pages, v_pages, meta["page_table"],
            meta["context_lens"], meta["query_start_loc"],
            meta["query_lens"], num_decode_seqs=meta["num_decode_seqs"],
            scale=self.cfg.resolved_head_dim ** -0.5, kernel_cfg=kernel_cfg,
        )[None]
        return self.wo(o.reshape(b, t, -1).to(x.dtype))

    def _write_kv(self, k, v, k_pages, v_pages, meta) -> None:
        """Write the step's K / V rows [B, S, Hkv, D] into this layer's
        pages at the step's write index (in place)."""
        hkv, d = k.shape[2], k.shape[3]
        index = meta["write_index"]
        scatter_kv(k_pages, k.reshape(-1, hkv, d).transpose(0, 1), index)
        scatter_kv(v_pages, v.reshape(-1, hkv, d).transpose(0, 1), index)

    def forward_prefill(self, x: torch.Tensor, positions: torch.Tensor,
                        k_pages: torch.Tensor, v_pages: torch.Tensor,
                        meta: dict, kernel_cfg=None) -> torch.Tensor:
        """Chunks of prompts: fresh at context 0, or resumed after a prior
        context in the pages (positions absolute, context_lens = prior +
        chunk).  x [B, S, d]; positions [B, S]; meta: page_table,
        context_lens, query_lens and the write index.  Returns [B, S, d]."""
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
                       meta: dict, kernel_cfg=None) -> torch.Tensor:
        """One token per slot.  x [B, 1, d]; positions [B, 1] (-1 on dead
        slots); meta: page_table, context_lens (0 on dead slots) and the
        write index.  Returns [B, 1, d]."""
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
