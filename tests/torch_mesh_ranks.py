"""What the port's mesh-training and sharding-rule tests run in each rank.

`repro_torch.launch.mesh.spawn_ranks` starts 4 fresh processes that
import this module (torch, numpy and repro_torch only, never JAX: the JAX
side of a test runs in the pytest process, and data crosses as numpy).
Each rank of the gloo world runs on the CPU with one intra-op thread, on
the (data 2, model 2) test mesh (rank = data * 2 + model), and returns
plain data.
"""
from __future__ import annotations

import contextlib
import io

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import weights
from repro_torch.configs import ARCHS, reduced
from repro_torch.core.paged.kv_cache import ShardingError
from repro_torch.distributed import pipeline, spmd
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import model as model_mod
from repro_torch.models import moe as moe_mod
from repro_torch.training import checkpoint as C
from repro_torch.training import trainer as T

BATCH_AXES = ("data",)


def port_cfg(arch: str, **overrides):
    return reduced(ARCHS[arch]).replace(dtype="float32", **overrides)


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def whole_params(model, state) -> dict:
    """{port parameter name: whole numpy array} (every rank gathers)."""
    return {k[len("params/"):]: v.numpy()
            for k, v in T.whole_state_tensors(model, state).items()
            if k.startswith("params/")}


@contextlib.contextmanager
def patched(module, name, value):
    prev = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, prev)


def kept_counter():
    """(counts, undo): wraps `MoE.capacity_slots` to append (kept pairs,
    routed pairs) of each call it makes."""
    counts, inner = [], moe_mod.MoE.capacity_slots

    def counted(self, topi, cap):
        slot, kept = inner(self, topi, cap)
        counts.append((int(kept.sum()), kept.numel()))
        return slot, kept

    moe_mod.MoE.capacity_slots = counted
    return counts, lambda: setattr(moe_mod.MoE, "capacity_slots", inner)


def update_recorder(names: list[str]):
    """(records, wrapper of `adamw_update`): each call appends, whole
    (every rank gathers) and in numpy, the gradients it is given (complete
    sums, before the clip), the parameters and moments before the update,
    the count, lr and the global norm."""
    records, inner = [], T.adamw_update

    def whole(ts, like):
        out = {}
        for name, t, p in zip(names, ts, like):
            if spmd.placement(p) is not None:
                t = spmd.full(spmd.set_placement(t, spmd.placement(p)))
            out[name] = t.detach().numpy().copy()
        return out

    def recording(grads, opt_state, params, **kw):
        records.append(dict(
            grads=whole(grads, params), params=whole(params, params),
            mu=whole(opt_state["mu"], params),
            nu=whole(opt_state["nu"], params),
            count=int(opt_state["count"]), lr=float(kw["lr"]),
            gnorm=float(kw["gnorm"])))
        return inner(grads, opt_state, params, **kw)

    return records, recording


def run_case(mesh, case: dict) -> dict:
    """One training case on the mesh: the model from the reference's
    weights, placed at `fsdp`, `len(batches)` steps of `train_step`; a
    forward-only call first counts the MoE's kept pairs; with `record`
    each AdamW update's inputs are recorded whole (`update_recorder`);
    with `ckpt` the whole state is saved after `ckpt_after` steps (rank 0
    writes)."""
    cfg = port_cfg(case["arch"], **case.get("overrides", {}))
    model = weights.from_jax_params(cfg, case["params"], device="cpu")
    state = T.make_train_state(model)
    n_whole = {n: p.numel() for n, p in model.named_parameters()}
    T.place_train_state(model, state, mesh=mesh, fsdp=case["fsdp"],
                        batch_axes=BATCH_AXES)
    rules = SH.make_rules(fsdp=case["fsdp"], sp=case.get("sp", True))
    out: dict = {"metrics": []}
    dispatch = torch.float32 if case.get("fp32_dispatch") else \
        moe_mod.DISPATCH_DTYPE
    group_size = case.get("group_size", moe_mod.MOE_GROUP_SIZE)
    records, update = update_recorder(list(n_whole))
    if not case.get("record"):
        update = T.adamw_update
    with SH.use_rules(mesh, rules), \
            patched(moe_mod, "DISPATCH_DTYPE", dispatch), \
            patched(moe_mod, "MOE_GROUP_SIZE", group_size), \
            patched(T, "adamw_update", update):
        if case.get("count_drops"):
            counts, undo = kept_counter()
            with torch.no_grad():
                first = to_torch(case["batches"][0])
                model_mod.apply_train(model, T.PS.assign_batch_shardings(
                    first, mesh=mesh, batch_axes=BATCH_AXES))
            undo()
            out["kept"] = counts
        for i, batch in enumerate(case["batches"]):
            state, m = T.train_step(model, state, to_torch(batch),
                                    **case["step_kw"])
            out["metrics"].append({k: float(v) for k, v in m.items()})
            if case.get("ckpt") and i + 1 == case["ckpt_after"]:
                whole = T.whole_state_tensors(model, state)
                if dist.get_rank() == 0:
                    C.save(case["ckpt"], whole, step=i + 1)
                dist.barrier()
        if case.get("record"):
            out["params"] = whole_params(model, state)
            if dist.get_rank() == 0:
                out["updates"] = records
    if case.get("layout"):
        params = list(model.named_parameters())
        out["layout"] = {
            name: (p.numel(), n_whole[name], spmd.placement(p),
                   spmd.placement(state["opt"]["mu"][i]),
                   spmd.placement(state["opt"]["nu"][i]),
                   state["opt"]["mu"][i].numel())
            for i, (name, p) in enumerate(params)}
    return out


def refusals(mesh) -> dict:
    """The ShardingError messages of a wrong world size and the production
    mesh on 4 ranks."""
    out = {}
    for what, call in (
            ("world", lambda: mesh_mod.make_mesh((2, 4), ("data", "model"),
                                                 device_type="cpu")),
            ("production", lambda: mesh_mod.make_production_mesh(
                device_type="cpu"))):
        try:
            call()
        except ShardingError as e:
            out[what] = str(e)
    return out


def launcher(argv: list[str]) -> str:
    """`launch.train.main(argv)` in this rank; its standard output."""
    from repro_torch.launch import train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(argv)
    return buf.getvalue()


def mesh_train_rank(rank: int, world: int, cases: dict,
                    launcher_argv: list[str]) -> dict:
    """Every case of `cases` in order on the (2, 2) mesh, then the
    refusals and the launcher."""
    torch.set_num_threads(1)
    mesh = mesh_mod.make_test_mesh()
    out = {name: run_case(mesh, case) for name, case in cases.items()}
    out["refusals"] = refusals(mesh)
    out["launcher"] = launcher(launcher_argv)
    out["coord"] = dict(mesh.coord)
    return out


def rules_rank(rank: int, world: int, shapes: list, pipe: dict) -> dict:
    """`sharding.resolve` and `constrain` on the (2, 2) mesh for each
    (global shape, logical axes) of `shapes`: the layout, and whether
    constrain of the whole array (held whole) gives this rank's block of
    it at that layout; then `pipeline_apply` over the 4 ranks as 4
    stages."""
    torch.set_num_threads(1)
    mesh = mesh_mod.make_test_mesh()
    out = {"layouts": [], "blocks_ok": [], "coord": dict(mesh.coord)}
    with SH.use_rules(mesh, SH.make_rules(sp=True)):
        for shape, axes in shapes:
            layout = SH.resolve(shape, *axes)
            whole = torch.arange(int(np.prod(shape)),
                                 dtype=torch.float32).reshape(shape)
            got = SH.constrain(whole, *axes)
            want = whole
            for dim, mesh_axes in enumerate(layout):
                if mesh_axes:
                    lo, hi = spmd.rank_range(shape[dim], mesh_axes)
                    want = want.narrow(dim, lo, hi - lo)
            # and back: the block held at the layout, gathered whole
            back = SH.constrain(got, *([None] * len(shape)), held=layout)
            out["layouts"].append(layout)
            out["blocks_ok"].append(bool(torch.equal(got, want))
                                    and bool(torch.equal(back, whole)))
        out["placements"] = [(type(p).__name__, getattr(p, "dim", None))
                             for p in SH.named_sharding(
                                 mesh, "batch", "seq_sp", "embed")]
    w = torch.from_numpy(pipe["w"])
    stages = pipeline.stage_split({"w": w}, world)["w"][rank]

    def stage_fn(ws, h):
        for wl in ws:
            h = torch.tanh(h @ wl)
        return h

    out["pipeline"] = pipeline.pipeline_apply(
        stage_fn, stages, torch.from_numpy(pipe["x"])).numpy()
    return out
