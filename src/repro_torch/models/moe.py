"""Mixture-of-Experts FFN: the serving path, the port of
`repro/models/moe.py:moe_ffn_dropless` (sort the rows by expert, one
ragged grouped GEMM, combine), and the training path, the port of
`moe_ffn` (the GShard capacity dispatch).

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

The training forward (`mode="train"`), general in top_k:

  1. the tokens in G groups of Sg (`MOE_GROUP_SIZE`, halved until it
     divides T), each expert taking at most C = max(int(Sg k cf / E), 1)
     rows a group;
  2. the same routing as serving (`route`);
  3. capacity positions in priority order (`capacity_slots`): choice j's
     position is the expert's count so far plus the choice-j rows before
     it in the group; a (token, choice) past C is dropped and adds
     nothing from the routed experts;
  4. the kept rows, rounded to bf16 as the reference's bf16 dispatch
     einsum rounds them whatever the param dtype (their gradient too),
     scattered into an [E, G C, d] buffer by index, the dropped ones to
     a trash row (at most one row a slot: no [G, Sg, E, C] one-hot is
     formed, and the backward adds into no slot twice), then three
     batched `torch.bmm` over E in the param dtype (the reference's
     expert einsums: XLA, outside any Pallas kernel);
  5. each (token, choice)'s row gathered back, weighted by its routing
     weight rounded to the expert output's dtype, summed in fp32 over the
     choices and rounded once to that dtype;
  6. the shared MLP added in that dtype (not in fp32 as serving does),
     the cast to x's dtype, and the Switch load-balance aux E ·
     Σ_e mean(onehot(top-1)) · mean(probs) · router_aux_coef.

Every shape follows from T, so the training forward reads nothing on the
host either, and `torch.utils.checkpoint`'s recompute takes the same
routing.

The expert-parallel serving form, `moe_ffn_dropless_ep` (the
reference's, over a process group where the reference has a mesh axis):
each of the n ranks keeps E / n experts (`shard_experts`, placed once
with the parameters: `param_sharding.shard_serve_experts`), routes every
token as the dropless path does (the activations are replicated between
blocks), runs the rows routed to its own experts on the grouped GEMM with
E / n groups (the rest sorted to the tail, which the kernel leaves alone
and the combine weighs by zero), and one fp32 `all_reduce` over the
group sums the ranks' outputs; the shared experts are added after it.
No token moves between ranks.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe import ops as moe_ops
from repro_torch.models import layers as L

MOE_GROUP_SIZE = 4096  # GShard grouping: the capacity is per group
DISPATCH_DTYPE = torch.bfloat16  # the reference's dispatch einsum's dtype


def capacity_layout(t: int, e: int, k: int,
                    capacity_factor: float) -> tuple[int, int, int]:
    """(group size Sg, groups G, capacity C) of T tokens, as `moe_ffn`
    computes them."""
    sg = min(MOE_GROUP_SIZE, t)
    while t % sg:
        sg //= 2
    return sg, t // sg, max(int(sg * k * capacity_factor / e), 1)


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        m = cfg.moe
        d, ff, e = cfg.d_model, m.d_ff_expert, m.num_experts
        dt = cfg.param_dtype
        self.top_k = m.top_k
        self.num_experts = e  # the router's; the stacks may hold E / n
        self.ep_serve = cfg.moe_ep_serve
        self.capacity_factor = m.capacity_factor
        self.aux_coef = m.router_aux_coef
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

    def probs(self, xt: torch.Tensor) -> torch.Tensor:
        """xt [T, d] -> the router's fp32 softmax [T, E]."""
        return torch.softmax(xt.float() @ self.router.w, dim=-1)

    def route(self, xt: torch.Tensor, probs: torch.Tensor | None = None):
        """xt [T, d] (or its router `probs`) -> (weights [T, k] fp32
        summing to 1, expert ids [T, k] int64, best first)."""
        if probs is None:
            probs = self.probs(xt)
        topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
        topw, topi = topw[:, :self.top_k], topi[:, :self.top_k]
        topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
        return topw, topi

    def capacity_slots(self, topi: torch.Tensor, cap: int):
        """topi [G, Sg, k] expert ids -> (slot [G, Sg, k] int64: the row
        e * G * C + g * C + position of the [E, G C, d] dispatch buffer,
        kept [G, Sg, k] bool).  Positions are taken in priority order, as
        `moe_ffn` takes them: choice j after every kept choice < j, in
        token order within it; a position >= C is dropped."""
        g, _, k = topi.shape
        e = self.w_gate.shape[0]
        counts = torch.zeros((g, 1, e), dtype=torch.int64,
                             device=topi.device)
        group = torch.arange(g, device=topi.device)[:, None]
        slots, kept = [], []
        for j in range(k):
            ids = topi[..., j:j + 1]  # [G, Sg, 1]
            onehot = torch.nn.functional.one_hot(ids[..., 0], e)
            pos = counts + torch.cumsum(onehot, dim=1) - onehot
            pos = torch.gather(pos, 2, ids)[..., 0]  # [G, Sg]
            keep = pos < cap
            counts = counts + torch.sum(onehot * keep[..., None], dim=1,
                                        keepdim=True)
            slots.append((ids[..., 0] * g + group) * cap + pos)
            kept.append(keep)
        return torch.stack(slots, -1), torch.stack(kept, -1)

    def forward(self, x: torch.Tensor, *, mode: str = "serve"):
        """x [..., d] -> (y in x's dtype, aux fp32 0-d): mode "serve" the
        dropless path (aux 0), "train" the capacity dispatch."""
        if self.w_gate.shape[0] != self.num_experts:
            raise ValueError(
                f"this MoE layer holds {self.w_gate.shape[0]} of its "
                f"{self.num_experts} experts (shard_experts): it runs only "
                f"expert parallel, inside use_expert_group")
        if mode == "train":
            return self.forward_train(x)
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

    def forward_train(self, x: torch.Tensor):
        """The GShard capacity dispatch (`moe_ffn`): x [..., d] -> (y in
        x's dtype, the load-balance aux fp32 0-d)."""
        d = x.shape[-1]
        xt = x.reshape(-1, d)
        t, k = xt.shape[0], self.top_k
        e = self.w_gate.shape[0]
        sg, g, cap = capacity_layout(t, e, k, self.capacity_factor)
        probs = self.probs(xt)
        topw, topi = self.route(xt, probs)
        slot, kept = self.capacity_slots(topi.reshape(g, sg, k), cap)
        slot, kept = slot.reshape(t * k), kept.reshape(t * k)
        n = e * g * cap  # slot n: the dropped rows' trash row
        slot = torch.where(kept, slot, n)
        # the dispatch einsum's bf16 rounding, forward and backward: the
        # buffer holds bf16 values in fp32, so a token's k gradient rows
        # are summed in fp32 and rounded to bf16 once, as XLA's dot does
        xr = xt.to(DISPATCH_DTYPE).float()
        src = xr.repeat_interleave(k, dim=0)  # row t * k + j
        buf = src.new_zeros((n + 1, d)).index_copy(0, slot, src)
        xe = buf[:n].reshape(e, g * cap, d).to(DISPATCH_DTYPE)
        # each expert einsum promotes xe to the param dtype on its own, so
        # its two gradients are rounded to bf16 before they are added
        h = torch.nn.functional.silu(
            torch.bmm(xe.to(self.w_gate.dtype), self.w_gate)) \
            * torch.bmm(xe.to(self.w_up.dtype), self.w_up)
        ye = torch.bmm(h, self.w_down).reshape(n, d)
        ye = torch.cat([ye, ye.new_zeros((1, d))])
        rows = ye.index_select(0, slot).float().reshape(t, k, d)
        w = (topw.to(ye.dtype).float() * kept.reshape(t, k))[..., None]
        y = w[:, 0] * rows[:, 0]
        for j in range(1, k):
            y = y + w[:, j] * rows[:, j]
        y = y.to(ye.dtype)
        if self.shared is not None:
            y = y + self.shared(xt).to(y.dtype)
        top1 = torch.nn.functional.one_hot(topi[:, 0], e).float()
        aux = e * torch.sum(top1.mean(0) * probs.mean(0)) * self.aux_coef
        return y.to(x.dtype).reshape(x.shape), aux


def shard_experts(moe: MoE, n: int, rank: int) -> MoE:
    """Cut, in place, `moe`'s expert stacks to rank `rank`'s block of E / n
    experts (the router and the shared experts stay whole); returns it."""
    e = moe.num_experts
    if e % n:
        raise ValueError(f"{e} experts do not split over {n} ranks")
    e_loc = e // n
    for name in ("w_gate", "w_up", "w_down"):
        w = getattr(moe, name)
        setattr(moe, name, nn.Parameter(
            w.data[rank * e_loc:(rank + 1) * e_loc].clone(),
            requires_grad=w.requires_grad))
    return moe


def moe_ffn_dropless_ep(moe: MoE, x: torch.Tensor, group=None):
    """The expert-parallel dropless MoE over process group `group` (None:
    the default group), the reference's `moe_ffn_dropless_ep`: x [..., d]
    replicated on every rank -> (y in x's dtype, replicated; aux fp32 0,
    as serving's).  `moe` holds this rank's E / n experts (`shard_experts`,
    placed once with the parameters).  Falls back to the plain dropless
    form when E does not divide over the ranks."""
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    e = moe.num_experts
    if e % n:
        return moe(x)
    e_loc = e // n
    if moe.w_gate.shape[0] != e_loc:
        raise ValueError(
            f"moe_ffn_dropless_ep over {n} ranks needs the layer cut to "
            f"its {e_loc} experts a rank (shard_experts), but it holds "
            f"{moe.w_gate.shape[0]}")
    ws = (moe.w_gate, moe.w_up, moe.w_down)
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    t, k = xt.shape[0], moe.top_k
    topw, topi = moe.route(xt)
    e_flat = topi.reshape(-1) - rank * e_loc  # the local expert id
    local = (e_flat >= 0) & (e_flat < e_loc)
    key = torch.where(local, e_flat, e_loc)  # other ranks' rows: the tail
    ids, order = torch.sort(key, stable=True)
    offsets = torch.searchsorted(
        ids, torch.arange(e_loc + 1, device=x.device), out_int32=True)
    pos = torch.empty_like(order).scatter_(
        0, order, torch.arange(t * k, device=x.device))
    xs = xt[order // k].to(ws[0].dtype)
    ys = moe_ops.expert_ffn(xs, offsets, *ws, tail=True)
    rows = ys[pos].float().reshape(t, k, d)
    w = topw * local.reshape(t, k)
    y = w[:, 0, None] * rows[:, 0]
    for j in range(1, k):
        y = y + w[:, j, None] * rows[:, j]
    dist.all_reduce(y, group=group)
    if moe.shared is not None:
        y = y + moe.shared(xt).float()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return y.to(x.dtype).reshape(x.shape), aux
