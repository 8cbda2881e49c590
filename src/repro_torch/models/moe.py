"""Mixture-of-Experts FFN, the serving path: the port of
`repro/models/moe.py:moe_ffn_dropless` (sort the rows by expert, one
ragged grouped GEMM, combine).

Parameters keep the reference's layout (`init_moe`): `router.w` [d, E]
fp32, `w_gate` / `w_up` [E, d, ff] and `w_down` [E, ff, d] in the param
dtype, and `shared` a SwiGLU `MLP` of width ff x num_shared_experts
(keys gate / up / down).

The forward, general in top_k:

  1. fp32 router logits, softmax;
  2. top-k by a stable descending sort: ties go to the lower expert id,
     as `jax.lax.top_k` breaks them (`torch.topk` promises no order among
     equal values); the weights renormalised to sum 1 (clipped at 1e-9);
  3. the flat expert ids [T k] in a stable sort on the device (the
     reference's stable argsort; nothing of size T k E, as a one-hot
     would be, is formed): the group offsets a search of the sorted ids
     for 0..E, each row's sorted position the inverse of the sort's
     permutation;
  4. the sorted rows gathered in the param dtype, then the two grouped
     GEMM launches (`kernels/moe/ops.py:expert_ffn`);
  5. the combine in fp32 through the inverse permutation, [T, k, d]
     summed over k in order (no atomics: the same bits every run; for
     k <= 2 the reference's scatter-add gives the same bits);
  6. the shared MLP added in fp32, the cast to x's dtype.

Nothing reads device data on the host, so the engine captures the step
into a CUDA graph.  Every row is routed, padding rows of a token bucket
too, as in the reference; they cost expert work and touch no other row.
The training path's capacity dispatch (`moe_ffn`) and the
expert-parallel `moe_ffn_dropless_ep` are not ported.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe import ops as moe_ops
from repro_torch.models import layers as L


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        m = cfg.moe
        d, ff, e = cfg.d_model, m.d_ff_expert, m.num_experts
        dt = cfg.param_dtype
        self.top_k = m.top_k
        self.router = L.Linear(d, e, dtype=torch.float32, device=device)

        def experts(*shape):
            return nn.Parameter(torch.empty(e, *shape, dtype=dt,
                                            device=device),
                                requires_grad=False)
        self.w_gate = experts(d, ff)
        self.w_up = experts(d, ff)
        self.w_down = experts(ff, d)
        self.shared = (L.MLP(d, ff * m.num_shared_experts, dtype=dt,
                             device=device)
                       if m.num_shared_experts else None)

    def route(self, xt: torch.Tensor):
        """xt [T, d] -> (weights [T, k] fp32 summing to 1, expert ids
        [T, k] int64, best first)."""
        probs = torch.softmax(xt.float() @ self.router.w, dim=-1)
        topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
        topw, topi = topw[:, :self.top_k], topi[:, :self.top_k]
        topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
        return topw, topi

    def forward(self, x: torch.Tensor, *, mode: str = "serve"):
        """x [..., d] -> (y in x's dtype, aux 0).  `mode` "train" raises:
        training needs the capacity dispatch."""
        if mode == "train":
            raise NotImplementedError(
                "MoE training is not ported yet: it needs the GShard "
                "capacity dispatch (repro.models.moe.moe_ffn)")
        d = x.shape[-1]
        xt = x.reshape(-1, d)
        t, k = xt.shape[0], self.top_k
        e = self.w_gate.shape[0]
        topw, topi = self.route(xt)
        e_flat = topi.reshape(-1)  # [T k]
        ids, order = torch.sort(e_flat, stable=True)  # order: sorted -> flat
        # group g's rows start where the sorted ids first reach g
        offsets = torch.searchsorted(
            ids, torch.arange(e + 1, device=x.device), out_int32=True)
        pos = torch.empty_like(order).scatter_(
            0, order, torch.arange(t * k, device=x.device))
        tok_of = order // k
        xs = xt[tok_of].to(self.w_gate.dtype)
        ys = moe_ops.expert_ffn(xs, offsets, self.w_gate, self.w_up,
                                self.w_down)
        rows = ys[pos].float().reshape(t, k, d)
        y = topw[:, 0, None] * rows[:, 0]
        for j in range(1, k):
            y = y + topw[:, j, None] * rows[:, j]
        if self.shared is not None:
            y = y + self.shared(xt).float()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return y.to(x.dtype).reshape(x.shape), aux
