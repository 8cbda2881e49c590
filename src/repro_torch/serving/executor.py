"""Where the engine's packed unified step runs: one device, or this rank's
share of a tensor-parallel group (the port of the reference's
`serving/executor.py`).

The engine schedules and packs on the host exactly as before.
`make_executor` returns a `DeviceMeshExecutor` that places the model and
the cache once at engine init and builds the step callable the engine
caches per kernel config:

  SingleDeviceExecutor    tp = 1: `apply_unified` as the engine has always
                          called it (graphs and all: the same function on
                          the same tensors)
  TensorParallelExecutor  tp > 1: every rank of a `torch.distributed`
                          group of tp ranks runs the same engine on the
                          same requests.  Only the attention head axis is
                          split: `wq` / `wk` / `wv` column-parallel in
                          whole heads, the KV pages on the head axis (each
                          rank holds Hkv / tp heads of EVERY page, so page
                          tables, slot mapping and query offsets stay
                          replicated and the scheduler is untouched), one
                          all-gather of the attention output before the
                          replicated `wo`, MLP, head and sampling.  No
                          contraction is split, so the tokens are those of
                          tp = 1, and each rank makes one step call a
                          step.  The step runs eager on every backend:
                          capturing it with a collective inside into a
                          CUDA graph waits for a run on several cards.
  PipelineParallelExecutor pp > 1: an interface stub.

Start the ranks with `repro_torch.launch.mesh.spawn_ranks` (gloo: ranks on
the CPU, or sharing one card; nccl: a card a rank) or with `torchrun
--nproc-per-node <tp>` and `torch.distributed.init_process_group`.
"""
from __future__ import annotations

import functools

import torch.distributed as dist

from repro_torch.core.paged.kv_cache import ShardingError, local_kv_heads
from repro_torch.distributed import param_sharding as PS
from repro_torch.distributed.sharding import ShardCtx, expert_group
from repro_torch.models import model as M


class DeviceMeshExecutor:
    """Contract between the engine and the devices.

    * `place_params` / `place_cache` run once at engine init and return
      the model and the cache this rank holds: `place_params` cuts the
      rank's leaves in place (the expert stacks of an expert-parallel MoE
      layer when an expert group is active, `use_expert_group`; at tp > 1
      also the wq / wk / wv heads), `place_cache` allocates the rank's KV
      pool at its own heads.
    * `build_unified(kernel_cfg)` returns the step callable
      `(model, cache, batch) -> apply_unified outputs` (with `sample` and
      `return_logits` set on a fused engine); the engine caches one per
      (token bucket, kernel config) key and calls it once a step.
    * Replicated or split is the executor's decision: the engine sees
      only placed tensors and callables.
    """

    tp: int = 1
    pp: int = 1

    def __init__(self, cfg, *, max_seqs: int, fused: bool,
                 max_draft: int = 0):
        self.cfg = cfg
        self.max_seqs = max_seqs
        self.fused = fused
        # speculative decoding: K > 0 switches the fused epilogue to the
        # [S, K+1] verify contract
        self.max_draft = max_draft

    def place_params(self, model):
        group = expert_group()
        if group is not None:
            PS.shard_serve_experts(model, group)
        return model

    def place_cache(self, *, max_seqs: int, num_pages: int, device) -> dict:
        return M.make_cache(self.cfg, max_seqs=max_seqs, num_pages=num_pages,
                            device=device, tp=self.tp)

    def _step_kwargs(self, kernel_cfg) -> dict:
        return dict(kernel_cfg=kernel_cfg, num_decode_seqs=self.max_seqs,
                    sample=self.fused, return_logits=self.fused,
                    max_draft=self.max_draft)

    def build_unified(self, kernel_cfg):
        raise NotImplementedError

    def describe(self) -> dict:
        return {"tp": self.tp, "pp": self.pp}


class SingleDeviceExecutor(DeviceMeshExecutor):
    """One device: exactly the engine's step without an executor."""

    def build_unified(self, kernel_cfg):
        return functools.partial(M.apply_unified,
                                 **self._step_kwargs(kernel_cfg))


class TensorParallelExecutor(DeviceMeshExecutor):
    """Head-axis tensor parallelism over a process group of tp ranks."""

    AXIS = "tp"

    def __init__(self, cfg, *, tp: int, group=None, graphs: bool = False,
                 **kw):
        super().__init__(cfg, **kw)
        self.tp = tp
        # whole heads a rank (also validates divisibility)
        local_kv_heads(cfg.num_kv_heads, tp, num_q_heads=cfg.num_q_heads)
        if graphs:
            raise ShardingError(
                f"tp={tp} runs the packed step eagerly: CUDA graph capture "
                f"of a step with its all-gather inside is not supported; "
                f"build the engine with cuda_graphs=False")
        size = (dist.get_world_size(group) if dist.is_initialized()
                else None)
        if size != tp:
            have = ("torch.distributed is not initialised"
                    if size is None else f"the process group has {size} "
                    f"ranks")
            raise ShardingError(
                f"tp={tp} needs a torch.distributed group of {tp} ranks "
                f"but {have}; start {tp} ranks with "
                f"repro_torch.launch.mesh.spawn_ranks (backend gloo on the "
                f"CPU or one shared card, nccl for a card a rank) or "
                f"torchrun --nproc-per-node={tp}, and pass the group")
        self.rank = dist.get_rank(group)
        self.shard = ShardCtx(axis=self.AXIS, size=tp, rank=self.rank,
                              group=group)

    def place_params(self, model):
        return super().place_params(
            PS.shard_serve_params(model, self.tp, self.rank))

    def build_unified(self, kernel_cfg):
        return functools.partial(M.apply_unified, shard=self.shard,
                                 **self._step_kwargs(kernel_cfg))


class PipelineParallelExecutor(DeviceMeshExecutor):
    """Interface stub: micro-batched packed steps over pp stages.

    The executor contract (place once, build per-config callables, one
    step call a step) is already shaped for it: a micro-batched
    `build_unified` would split the packed token stream into in-flight
    micro-steps on the devices, with no engine or scheduler change.
    """

    def __init__(self, cfg, *, pp: int, **kw):
        raise NotImplementedError(
            f"pipeline-parallel packed serving (pp={pp}) is an interface "
            f"stub; only tp groups execute today")


def make_executor(cfg, *, tp: int = 1, pp: int = 1, group=None,
                  max_seqs: int, fused: bool, packed: bool = True,
                  max_draft: int = 0, graphs: bool = False):
    """The executor of an engine: `group` is the tp ranks' process group
    (None: the default group), `graphs` whether the engine captures its
    steps into CUDA graphs."""
    kw = dict(max_seqs=max_seqs, fused=fused, max_draft=max_draft)
    if pp > 1:
        return PipelineParallelExecutor(cfg, pp=pp, **kw)
    if tp > 1:
        if not packed:
            raise ShardingError(
                "the mesh executor only runs the packed unified step; "
                f"tp={tp} with packed_attention=False (padded per-kind "
                f"launches) is not supported")
        return TensorParallelExecutor(cfg, tp=tp, group=group,
                                      graphs=graphs, **kw)
    return SingleDeviceExecutor(cfg, **kw)
