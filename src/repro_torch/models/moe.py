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
from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import (
    active_mesh, constrain, resolve, spec,
)
from repro_torch.kernels.moe import ops as moe_ops
from repro_torch.models import layers as L
from repro_torch.roofline.analysis import collective

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
        return torch.softmax(xt.float() @ spmd.full(self.router.w), dim=-1)

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
        e = self.num_experts
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

    def forward(self, x: torch.Tensor, *, mode: str = "serve",
                packed: bool = False):
        """x [..., d] -> (y in x's dtype, aux fp32 0-d): mode "serve" the
        dropless path (aux 0; `packed`: the packed step's, its shared
        experts on `MLP.forward_serve`), "train" the capacity dispatch."""
        if mode == "train":
            return self.forward_train(x)
        if (spmd.placement(self.w_gate) is None
                and self.w_gate.shape[0] != self.num_experts):
            raise ValueError(
                f"this MoE layer holds {self.w_gate.shape[0]} of its "
                f"{self.num_experts} experts (shard_experts): it runs only "
                f"expert parallel, inside use_expert_group")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return moe_ffn_dropless_mesh(self, x, packed=packed), aux

    def forward_train(self, x: torch.Tensor):
        """The GShard capacity dispatch (`moe_ffn`): x [..., d] -> (y in
        x's dtype, the load-balance aux fp32 0-d).

        On a training mesh x is this rank's batch rows (whole over
        'model') and so is y.  The group size and capacity follow the
        global token count (B S of the whole batch), and the groups lie on
        the batch axes where they divide over them; where they do not, the
        tokens are all-gathered and every rank routes every group (the
        reference's replicated fallback), then keeps its own rows of y.
        Each rank runs its block of the experts on the rows routed to
        them; the combine is a pending sum over 'model', summed in fp32
        before the reference's rounding.  The aux takes the global means
        of the top-1 one-hot and the router probabilities (a product of
        means, not a mean of products)."""
        d = x.shape[-1]
        xt = x.reshape(-1, d)
        t_loc, k = xt.shape[0], self.top_k
        e = self.num_experts
        batch = spec("batch")[0]
        nb = spmd.axes_size(batch)
        sg, g, cap = capacity_layout(t_loc * nb, e, k, self.capacity_factor)
        xg_held = resolve((g, sg, d), "batch", None, "embed")
        e_axes = resolve((e,), "experts")[0]
        if xg_held[0] is None and nb > 1:  # every rank routes every group
            xt = spmd.all_gather(xt, 0, batch)
        g_loc = xt.shape[0] // sg
        xg = constrain(xt.reshape(g_loc, sg, d), "batch", None, "embed",
                       held=xg_held)
        xt = xg.reshape(-1, d)
        t = xt.shape[0]
        probs = self.probs(xt)
        topw, topi = self.route(xt, probs)
        slot, kept = self.capacity_slots(topi.reshape(g_loc, sg, k), cap)
        # the reference's dispatch / combine one-hots [G, Sg, E, C] are
        # these slots and flags [G, Sg, k]
        slot = constrain(slot, "batch", None, None, held=xg_held)
        kept = constrain(kept, "batch", None, None, held=xg_held)
        e_lo, e_hi = spmd.rank_range(e, e_axes)
        e_loc = e_hi - e_lo
        slot, kept = slot.reshape(t * k), kept.reshape(t * k)
        mine = kept
        if e_loc < e:  # this rank's experts only
            ids = topi.reshape(t * k)
            mine = kept & (ids >= e_lo) & (ids < e_hi)
        n = e_loc * g_loc * cap  # slot n: the dropped rows' trash row
        slot = torch.where(mine, slot - e_lo * g_loc * cap, n)
        # the dispatch einsum's bf16 rounding, forward and backward: the
        # buffer holds bf16 values in fp32, so a token's k gradient rows
        # are summed in fp32 and rounded to bf16 once, as XLA's dot does
        xr = xt.to(DISPATCH_DTYPE).float()
        src = xr.repeat_interleave(k, dim=0)  # row t * k + j
        buf = src.new_zeros((n + 1, d)).index_copy(0, slot, src)
        xe = buf[:n].reshape(e_loc, g_loc * cap, d).to(DISPATCH_DTYPE)
        ex_held = (e_axes, xg_held[0], None, None)
        xe = constrain(xe.view(e_loc, g_loc, cap, d), "experts", "batch",
                       "expert_cap", "embed", held=ex_held).flatten(1, 2)
        wg, wu, wd = (spmd.local_block(w, 0, e_lo, e_hi)
                      for w in (self.w_gate, self.w_up, self.w_down))
        # each expert einsum promotes xe to the param dtype on its own, so
        # its two gradients are rounded to bf16 before they are added
        h = torch.nn.functional.silu(torch.bmm(xe.to(wg.dtype), wg)) \
            * torch.bmm(xe.to(wu.dtype), wu)
        h = constrain(h.view(e_loc, g_loc, cap, -1), "experts", "batch",
                      "expert_cap", None, held=ex_held).flatten(1, 2)
        ye = torch.bmm(h, wd)
        ye = constrain(ye.view(e_loc, g_loc, cap, d), "experts", "batch",
                       "expert_cap", "embed", held=ex_held).reshape(n, d)
        ye = torch.cat([ye, ye.new_zeros((1, d))])
        rows = ye.index_select(0, slot).float().reshape(t, k, d)
        w = (topw.to(ye.dtype).float() * mine.reshape(t, k))[..., None]
        y = w[:, 0] * rows[:, 0]
        for j in range(1, k):
            y = y + w[:, j] * rows[:, j]
        if e_loc < e:  # the other ranks' experts' rows
            y = spmd.all_reduce(y, e_axes)
        y = y.to(ye.dtype)
        if self.shared is not None:
            ys, split = self.shared.forward_partial(xt)
            if split:
                ys = spmd.all_reduce(ys, ("model",))
            y = y + ys.to(y.dtype)
        top1 = torch.nn.functional.one_hot(topi[:, 0], e).float()
        if xg_held[0] is None:  # every token is here
            frac_tokens, frac_probs = top1.mean(0), probs.mean(0)
        else:  # the means over the whole batch
            total = t * nb
            frac_tokens = spmd.all_reduce(top1.sum(0), batch) / total
            frac_probs = spmd.all_reduce(probs.sum(0), batch) / total
        aux = e * torch.sum(frac_tokens * frac_probs) * self.aux_coef
        if t != t_loc:  # this rank's own rows of the gathered tokens
            y = y.narrow(0, active_mesh().index(batch) * t_loc, t_loc)
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


def moe_ffn_dropless_ep(moe: MoE, x: torch.Tensor, group=None,
                        packed: bool = False):
    """The expert-parallel dropless MoE over process group `group` (None:
    the default group), the reference's `moe_ffn_dropless_ep`: x [..., d]
    replicated on every rank -> (y in x's dtype, replicated; aux fp32 0,
    as serving's).  `moe` holds this rank's E / n experts (`shard_experts`,
    placed once with the parameters).  Falls back to the plain dropless
    form when E does not divide over the ranks.  `packed`: the packed
    step's, its shared experts on `MLP.forward_serve`."""
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    e = moe.num_experts
    if e % n:
        return moe(x, packed=packed)
    e_loc = e // n
    if moe.w_gate.shape[0] != e_loc:
        raise ValueError(
            f"moe_ffn_dropless_ep over {n} ranks needs the layer cut to "
            f"its {e_loc} experts a rank (shard_experts), but it holds "
            f"{moe.w_gate.shape[0]}")
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    y = _dropless_local(moe, xt, (moe.w_gate, moe.w_up, moe.w_down),
                        rank * e_loc)
    with collective("all-reduce", y.numel() * y.element_size()):
        dist.all_reduce(y, group=group)
    if moe.shared is not None:
        shared = moe.shared.forward_serve if packed else moe.shared
        y = y + shared(xt).float()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return y.to(x.dtype).reshape(x.shape), aux


def _dropless_local(moe: MoE, xt: torch.Tensor, ws, e_lo: int) -> torch.Tensor:
    """The dropless combine [T, d] fp32 of the rows of xt [T, d] routed to
    experts [e_lo, e_lo + E_loc), whose stacks `ws` (w_gate, w_up,
    w_down) hold: every row routed as the dropless path routes it, the
    rows of other experts (where E_loc < E) sorted to the tail (which the
    grouped GEMM leaves alone) and weighed by zero.  The launches' recorded work counts
    the rows balanced routing sends to E_loc of the E experts."""
    t, k, d = xt.shape[0], moe.top_k, xt.shape[1]
    e_loc = ws[0].shape[0]
    topw, topi = moe.route(xt)
    e_flat = topi.reshape(-1) - e_lo  # the local expert id
    local = (e_flat >= 0) & (e_flat < e_loc)
    key = torch.where(local, e_flat, e_loc)  # other experts' rows: the tail
    ids, order = torch.sort(key, stable=True)
    offsets = torch.searchsorted(
        ids, torch.arange(e_loc + 1, device=xt.device), out_int32=True)
    pos = torch.empty_like(order).scatter_(
        0, order, torch.arange(t * k, device=xt.device))
    xs = xt[order // k].to(ws[0].dtype)
    ys = moe_ops.expert_ffn(xs, offsets, *ws,
                            tail=e_loc < moe.num_experts,
                            routed_rows=t * k * e_loc // moe.num_experts)
    rows = ys[pos].float().reshape(t, k, d)
    w = topw * local.reshape(t, k)
    y = w[:, 0, None] * rows[:, 0]
    for j in range(1, k):
        y = y + w[:, j, None] * rows[:, j]
    return y


def moe_ffn_dropless_mesh(moe: MoE, x: torch.Tensor, *,
                          packed: bool = False) -> torch.Tensor:
    """The dropless serving MoE (`MoE.forward`'s serve mode): x [..., d]
    -> y in x's dtype, every expert on one device without a mesh.  Under
    a mesh's rules (the dry run's serving cells) x is this rank's batch
    rows, whole over 'model'.  The expert stacks are split over
    'model' where E divides it (`param_sharding.param_spec`; under FSDP
    their d dim is gathered where they are used): the rank routes every
    row, runs the rows routed to its E / M experts and the combine is
    summed over 'model'; the shared experts run tensor-parallel (whole,
    on `MLP.forward_serve`, in the packed step: `packed`)."""
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    e_axes = resolve((moe.num_experts,), "experts")[0]
    e_lo, e_hi = spmd.rank_range(moe.num_experts, e_axes)
    ws = tuple(spmd.local_block(w, 0, e_lo, e_hi)
               for w in (moe.w_gate, moe.w_up, moe.w_down))
    y = spmd.all_reduce(_dropless_local(moe, xt, ws, e_lo), e_axes)
    if moe.shared is not None:
        ys, split = ((moe.shared.forward_serve(xt), False) if packed
                     else moe.shared.forward_partial(xt))
        if split:
            ys = spmd.all_reduce(ys, ("model",))
        y = y + ys.float()
    return y.to(x.dtype).reshape(x.shape)
