"""GQA attention over the paged KV cache, unified (token-packed) mode only.

One step: QKV projections, packed-position RoPE (each token rotates by its
own absolute position), the KV page write at the host-computed
`slot_mapping` (in place; padded tokens aim at the out-of-range trash slot
and are dropped), one unified attention launch over decode rows and
prefill chunks, then `wo`.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import backend as attn_backend
from repro_torch.core.paged.kv_cache import scatter_kv
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
        query_start_loc, num_decode_seqs, and the step's live write index
        `write_rows` / `write_dest` (`kv_cache.live_slots` of
        slot_mapping).  Returns [1, T, d]."""
        b, t, _ = x.shape
        q, k, v = self.qkv(x, positions)
        rows, dest = meta["write_rows"], meta["write_dest"]
        scatter_kv(k_pages, k[0].transpose(0, 1), rows, dest)
        scatter_kv(v_pages, v[0].transpose(0, 1), rows, dest)
        o =attn_backend.unified_attention(
            q[0], k_pages, v_pages, meta["page_table"],
            meta["context_lens"], meta["query_start_loc"],
            meta["query_lens"], num_decode_seqs=meta["num_decode_seqs"],
            scale=self.cfg.resolved_head_dim ** -0.5, kernel_cfg=kernel_cfg,
        )[None]
        return self.wo(o.reshape(b, t, -1).to(x.dtype))
