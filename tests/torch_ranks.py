"""What the port's multi-rank tests run in each rank.

`repro_torch.launch.mesh.spawn_ranks` starts the ranks as fresh
processes that import this module (it imports only torch, numpy and
repro_torch, never JAX: the JAX side of a test runs in the pytest
process, and data crosses as numpy).  Each function runs in every rank
of one gloo world on the CPU, one intra-op thread a rank, and returns
plain data.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import weights
from repro_torch.configs import ARCHS, reduced
from repro_torch.core.paged.kv_cache import ShardingError
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import use_expert_group
from repro_torch.launch.mesh import make_tp_group
from repro_torch.models import model as model_mod
from repro_torch.models.model import Block
from repro_torch.models.moe import MoE, moe_ffn_dropless_ep, shard_experts
from repro_torch.serving.engine import Engine
from repro_torch.serving.executor import SingleDeviceExecutor
from repro_torch.serving.request import Request


def port_cfg(arch: str = "smollm-135m", **overrides):
    return reduced(ARCHS[arch]).replace(dtype="float32", **overrides)


def run_trace(cfg, params: dict, trace: dict, **engine_kw) -> dict:
    """One engine over a trace, stepped to completion: outputs, per-step
    debug logits and stats, device calls."""
    eng = Engine(cfg, weights.from_jax_params(cfg, params, device="cpu"),
                 device="cpu", debug_logits=True, **trace["engine"],
                 **engine_kw)
    reqs = [Request(prompt=list(p), max_new_tokens=trace["new"])
            for p in trace["prompts"]]
    for r in reqs:
        eng.add_request(r)
    logits, stats = [], []
    while eng.sched.has_work:
        stats.append(eng.step())
        logits.append(eng.last_step_logits.numpy().copy())
    return dict(outputs=[r.output for r in reqs], logits=logits,
                steps=eng.step_idx, device_calls=dict(eng.device_calls),
                preempted=sum(s["preempted"] for s in stats),
                partial=sum(s["partial_prefills"] for s in stats),
                num_devices={s["pool"]["num_devices"] for s in stats},
                spec_stats=dict(eng.spec_stats),
                free_pages=eng.alloc.free_pages, num_pages=eng.num_pages,
                pool={n: t.numpy().copy()
                      for n, t in eng.cache["attn"].items()})


def serve_rank(rank: int, world: int, params: dict, fused_params: dict,
               heads: dict, traces: dict) -> dict:
    """4 ranks: ranks 0, 1, 2 run the mixed, the speculative and the
    fused-wqkv trace at tp 1 (one each); all four the mixed trace at tp
    4; each pair (0, 1), (2, 3) the three traces at tp 2; then the engine
    is built over the default group of 4 at tp 2 (the wrong size)."""
    torch.set_num_threads(1)
    cfg = port_cfg(**heads)
    fused_cfg = cfg.replace(fused_qkv=True)
    tp2 = make_tp_group(2, backend="gloo")
    out = {}
    if rank == 0:
        out["tp1"] = run_trace(cfg, params, traces["mixed"])
    elif rank == 1:
        out["spec_tp1"] = run_trace(cfg, params, traces["spec"])
    elif rank == 2:
        out["fused_tp1"] = run_trace(fused_cfg, fused_params,
                                     traces["fused"])
    out["tp4"] = run_trace(cfg, params, traces["mixed"], tp=4)
    out["tp2"] = run_trace(cfg, params, traces["mixed"], tp=2, tp_group=tp2)
    out["spec_tp2"] = run_trace(cfg, params, traces["spec"], tp=2,
                                tp_group=tp2)
    out["fused_tp2"] = run_trace(fused_cfg, fused_params, traces["fused"],
                                 tp=2, tp_group=tp2)
    try:
        Engine(cfg, weights.from_jax_params(cfg, params, device="cpu"),
               device="cpu", tp=2, **traces["mixed"]["engine"])
    except ShardingError as e:
        out["wrong_group"] = str(e)
    return out


def moe_from_numpy(cfg, p: dict) -> MoE:
    """The port's MoE layer holding the reference's `init_moe` tree."""
    moe = MoE(cfg, device="cpu")
    with torch.no_grad():
        moe.router.w.copy_(torch.tensor(p["router"]["w"]))
        for name in ("w_gate", "w_up", "w_down"):
            getattr(moe, name).copy_(torch.tensor(p[name]))
        if moe.shared is not None:
            for name in ("gate", "up", "down"):
                getattr(moe.shared, name).w.copy_(
                    torch.tensor(p["shared"][name]["w"]))
    return moe


def distributed_rank(rank: int, world: int, moe_params: dict,
                     moe_arch: str, x: np.ndarray, grads: np.ndarray,
                     ef_steps: int) -> dict:
    """4 ranks: a MoE block with `moe_ep_serve` whose experts an executor
    placed under the world as its expert group, its serving FFN inside the
    group and outside it, and a block without an expert group;
    `moe_ffn_dropless_ep` over ranks 0-2 (E does not divide: the plain
    form), over the world with the experts cut to the rank's E / 4, and
    with every expert held (refused); then the collectives on rank
    `rank`'s row of `grads`: `int8_ef_allgather` one step and `ef_steps`
    steps with error feedback, `bf16_psum`."""
    torch.set_num_threads(1)
    cfg = port_cfg(moe_arch)
    full = moe_from_numpy(cfg, moe_params)
    xt = torch.from_numpy(x)
    three = dist.new_group([0, 1, 2], backend="gloo")
    ep_cfg = cfg.replace(moe_ep_serve=True)

    def block():
        blk = Block(ep_cfg, use_moe=True, device="cpu")
        blk.moe = moe_from_numpy(ep_cfg, moe_params)
        return blk

    blk, plain_blk = block(), block()
    ep_calls = []

    def counted_ep(*a):
        ep_calls.append(1)
        return moe_ffn_dropless_ep(*a)

    model_mod.moe_ffn_dropless_ep = counted_ep
    with torch.no_grad(), use_expert_group(dist.group.WORLD):
        SingleDeviceExecutor(ep_cfg, max_seqs=1, fused=False) \
            .place_params(blk)
        via_block = blk.ffn(xt)
    with torch.no_grad():
        outside = plain_blk.ffn(xt)  # no expert group: the plain form
        try:
            blk.ffn(xt)  # the cut layer outside its group
        except ValueError as e:
            cut_outside = str(e)
    model_mod.moe_ffn_dropless_ep = moe_ffn_dropless_ep
    with torch.no_grad():
        try:
            moe_ffn_dropless_ep(full, xt)
        except ValueError as e:
            held = str(e)
        fallback = (moe_ffn_dropless_ep(full, xt, three)[0].numpy()
                    if rank < 3 else None)
        cut, _ = moe_ffn_dropless_ep(shard_experts(full, world, rank), xt)
    g = torch.from_numpy(grads[rank])
    ef = torch.zeros_like(g)
    one, ef1 = collectives.int8_ef_allgather(g, None, ef)
    sums = []
    for _ in range(ef_steps):
        s, ef = collectives.int8_ef_allgather(g, None, ef)
        sums.append(s.numpy())
    tree = {"a": g, "b": [2 * g]}
    psum = collectives.bf16_psum(tree, None)
    return dict(ep_cut=cut.numpy(), ep_three=fallback, held_error=held,
                ep_block=via_block.numpy(), ep_block_calls=len(ep_calls),
                plain_block=outside.numpy(), cut_outside=cut_outside,
                placed_experts=blk.moe.w_gate.shape[0], int8=one.numpy(),
                int8_ef=ef1.numpy(), int8_steps=np.stack(sums),
                bf16=psum["a"].numpy(), bf16_tree=psum["b"][0].numpy())
