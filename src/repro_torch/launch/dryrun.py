"""Multi-pod dry run of the port: for every (architecture x input shape x
mesh) cell of the reference, one rank's real step on meta tensors, with
its per-rank memory, counted FLOPs and bytes, collectives by kind, and
roofline terms.

Per cell:
  1. this process becomes rank 0 of a fake world (`launch.mesh.
     fake_world`) of 256 ranks, the reference's single pod (data 16,
     model 16), or 512, its two pods (pod 2, data 16, model 16): the
     reference's TPU mesh geometry laid over H100 ranks, 8 a node;
  2. the model, its train state or serving cache and the batch are built
     on the meta device at full size and placed at the reference's
     layouts (`param_sharding.assign_param_shardings`, `assign_cache_
     shardings`, `assign_batch_shardings`; FSDP for the architectures
     of `sharding.FSDP_ARCHS`, in the placement and the rules alike):
     the rank keeps its blocks;
  3. the step runs once, eagerly, under the mesh's rules: `train_step`
     (loss, backward, the gradient reduction, AdamW), or `apply_prefill`
     / `apply_decode`.  Every collective goes to the fake world and moves
     nothing; every kernel wrapper returns empty meta outputs and records
     its work; `roofline.analysis.StepCounter` counts the FLOPs, bytes,
     collective bytes and the storages the step makes.

Every number of a record is analytic: shapes through formulas and the
H100 data-sheet rates of `roofline.hw`, nothing measured.  The count
runs every layer (eager execution), so it is exact at full depth; the
reference's two-depth extrapolation (`roofline_depths`, `analysis.
extrapolate`) is kept as a check of it (`extrapolated_cost`).  The xLSTM
scans need no analytic correction: each chunk and time step is counted.

Artifacts: dryrun_out/<arch>__<shape>__<mesh>.json (at the repository
root; ignored by git).

Usage:
  python -m repro_torch.launch.dryrun [--arch A] [--shape S]
      [--mesh single|multi] [--no-roofline] [--skip-existing] [--list]
      [--out DIR]
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import time
import traceback
from pathlib import Path

from repro_torch.configs import ARCHS, SHAPES, input_specs, shape_applies
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.distributed import param_sharding as PS
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models import model as M
from repro_torch.roofline import analysis as RA
from repro_torch.roofline import hw
from repro_torch.training import trainer as T
from repro_torch.utils.misc import cdiv

ARTIFACT_DIR = str(Path(__file__).resolve().parents[3] / "dryrun_out")

MESH_NOTE = ("the reference's TPU mesh geometry ((data 16, model 16) or "
             "(pod 2, data 16, model 16)) laid over H100 ranks, 8 a node; "
             "rank 0 of a fake world, its step run on meta tensors")


# ---------------------------------------------------------------------------
# analytic parameter / FLOP model
# ---------------------------------------------------------------------------

def count_params(cfg: ModelConfig) -> tuple[int, int]:
    """(total, active) parameter counts of the model built on the meta
    device."""
    model = M.Model(cfg, device="meta")
    total = sum(p.numel() for p in model.parameters())
    active = total
    if cfg.moe.num_experts:
        m = cfg.moe
        n_moe_layers = M.moe_layout(cfg)[1]
        inactive_experts = m.num_experts - m.top_k
        active -= 3 * cfg.d_model * m.d_ff_expert * inactive_experts \
            * n_moe_layers
    return total, active


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """MODEL_FLOPS: 6 N_active D (train) / 2 N_active D (inference)."""
    _, active = count_params(cfg)
    if shape.kind == "train":
        return 6.0 * active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * active * shape.global_batch * shape.seq_len
    return 2.0 * active * shape.global_batch  # decode: one token per seq


# ---------------------------------------------------------------------------
# per-cell step construction
# ---------------------------------------------------------------------------

def _pool_layout(cfg, shape, data_n):
    b = shape.global_batch
    pools = data_n if b % data_n == 0 else 1
    pages_per_seq = cdiv(shape.seq_len, cfg.page_size)
    pages_per_pool = (b // pools) * pages_per_seq + 1  # +1 NULL page
    return pools, pages_per_pool, pages_per_seq


def batch_axes_of(multi_pod: bool) -> tuple:
    return ("pod", "data") if multi_pod else ("data",)


def _model(cfg: ModelConfig, device) -> M.Model:
    """The whole model: empty on the meta device, else random weights
    from seed 0 (`weights.init_random`)."""
    if str(device) == "meta":
        return M.Model(cfg, device="meta")
    from repro_torch.weights import init_random

    return init_random(cfg, 0, device=device)


def build_cell(cfg: ModelConfig, shape: InputShape, mesh, *,
               multi_pod: bool, microbatches: int = 1,
               device="meta", batch: dict | None = None):
    """(step, arguments): `step()` runs this rank's step of the cell once
    (under the mesh's rules, entered by the caller), `arguments` = (the
    parameters and train state or cache, this rank's batch blocks) whose
    bytes are the step's arguments.  `mesh` None: one device, nothing
    placed.  `batch` (the global batch) defaults to `input_specs`' meta
    tensors; a real run passes data."""
    batch_axes = batch_axes_of(multi_pod)
    fsdp = SH.uses_fsdp(cfg)
    data_n = 1 if mesh is None else math.prod(mesh.shape[a]
                                              for a in batch_axes)

    def local(b):
        if mesh is None:
            return b
        return PS.assign_batch_shardings(b, mesh=mesh, batch_axes=batch_axes)

    if shape.kind == "train":
        if str(device) == "meta":
            model, state = T.make_train_state_abstract(cfg)
        else:
            model = _model(cfg, device)
            state = T.make_train_state(model)
        if mesh is not None:
            T.place_train_state(model, state, mesh=mesh, fsdp=fsdp,
                                batch_axes=batch_axes)
        if batch is None:
            batch = input_specs(cfg, shape)

        def step():
            return T.train_step(model, state, batch,
                                microbatches=microbatches)
        return step, ((list(model.parameters()), state), local(batch))

    model = _model(cfg, device)
    pools, pages_per_pool, pages_per_seq = _pool_layout(cfg, shape, data_n)
    cache = M.make_cache(cfg, max_seqs=shape.global_batch,
                         num_pages=pages_per_pool, device=device,
                         num_pools=pools)
    if mesh is not None:
        PS.assign_param_shardings(model, mesh=mesh, fsdp=fsdp,
                                  batch_axes=batch_axes)
        cache = PS.assign_cache_shardings(cache, mesh=mesh,
                                          batch_axes=batch_axes)
    if batch is None:
        batch = input_specs(cfg, shape, pages_per_seq=pages_per_seq)
    batch = local(batch)
    apply = M.apply_prefill if shape.kind == "prefill" else M.apply_decode

    def step():
        return apply(model, cache, batch)
    return step, ((list(model.parameters()), cache), batch)


def rules_for(cfg: ModelConfig, shape: InputShape, multi_pod: bool) -> dict:
    return SH.make_rules(multi_pod=multi_pod,
                         fsdp=SH.uses_fsdp(cfg),
                         sp=(shape.kind == "train"))


def count_cell(cfg: ModelConfig, shape: InputShape, mesh, *,
               multi_pod: bool, microbatches: int = 1, device="meta",
               batch: dict | None = None) -> dict:
    """Build the cell and count one run of its step (`RA.StepCounter`):
    {"count": the `RA.Count`, "argument_bytes", "output_bytes",
    "peak_bytes", "output"}.  Under the mesh's rules when `mesh` is given
    (the caller has a world of its ranks up)."""
    step, (state, batch_local) = build_cell(
        cfg, shape, mesh, multi_pod=multi_pod, microbatches=microbatches,
        device=device, batch=batch)
    arg_bytes = RA.storage_bytes(state) + sum(
        t.numel() * t.element_size() for t in batch_local.values())
    rules = None if mesh is None else rules_for(cfg, shape, multi_pod)
    gc.collect()  # earlier garbage would be freed inside the count
    with (SH.use_rules(mesh, rules) if mesh is not None
          else contextlib.nullcontext()), RA.StepCounter() as counter:
        out = step()
        out_bytes = counter.fresh_bytes(out)
    count = counter.snapshot()
    return {"count": count, "argument_bytes": arg_bytes,
            "output_bytes": out_bytes, "peak_bytes": count.peak_bytes,
            "output": out}


def roofline_depths(cfg: ModelConfig) -> tuple[int, int, tuple]:
    """(L1, L2, (u1, u2, full_units)): the reference's depth pair and
    unit counts for `analysis.extrapolate`."""
    if cfg.family == "hybrid":
        p = cfg.ssm.shared_attn_period
        return 2 * p, 4 * p, (2 * p, 4 * p, cfg.num_layers)
    if cfg.family == "ssm":
        p = cfg.ssm.slstm_period
        return p, 2 * p, (p, 2 * p, cfg.num_layers)
    lead = cfg.moe.first_k_dense if cfg.moe.num_experts else 0
    return lead + 2, lead + 4, (2, 4, cfg.num_layers - lead)


def extrapolated_cost(cfg: ModelConfig, shape: InputShape, mesh, *,
                      multi_pod: bool, microbatches: int = 1,
                      device="meta") -> RA.CellCost:
    """The reference's method: counts at the two depths of
    `roofline_depths`, extrapolated linearly to the full depth."""
    l1, l2, (u1, u2, ufull) = roofline_depths(cfg)
    depth_costs = {}
    for lx, ux in ((l1, u1), (l2, u2)):
        got = count_cell(cfg.replace(num_layers=lx), shape, mesh,
                         multi_pod=multi_pod, microbatches=microbatches,
                         device=device)
        depth_costs[ux] = got["count"].triple()
    return RA.extrapolate(depth_costs, ufull)


def _rates() -> dict:
    return {"source": hw.RATES_SOURCE,
            "peak_flops_bf16": hw.PEAK_FLOPS_BF16, "hbm_bw": hw.HBM_BW,
            "collective_bw": hw.COLLECTIVE_BW,
            "collective_link": "InfiniBand NDR, 400 Gb/s a GPU",
            "axis_link": dict(hw.AXIS_LINK),
            "gpus_per_node": hw.GPUS_PER_NODE,
            "hbm_per_chip": hw.HBM_PER_CHIP}


def _write(record: dict, out_dir: str, name: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(record, f, indent=1)


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             roofline: bool = True, out_dir: str = ARTIFACT_DIR,
             cfg_overrides: dict | None = None, microbatches: int = 1,
             tag: str = "") -> dict:
    """One cell at rank 0 of a fake world of its mesh's size, written to
    `out_dir`/<arch>__<shape>__<mesh>[__tag].json; returns the record."""
    cfg = ARCHS[arch]
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    shape = SHAPES[shape_name]
    multi_pod = mesh_kind == "multi"
    applies, reason = shape_applies(cfg, shape)
    record: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "status": "skip", "reason": reason,
        "tag": tag, "cfg_overrides": cfg_overrides or {},
        "microbatches": microbatches,
    }
    suffix = f"__{tag}" if tag else ""
    fname = f"{arch}__{shape_name}__{mesh_kind}{suffix}.json"
    if not applies:
        _write(record, out_dir, fname)
        return record
    chips = hw.CHIPS_MULTI_POD if multi_pod else hw.CHIPS_SINGLE_POD
    t0 = time.time()
    with fake_world(chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        got = count_cell(cfg, shape, mesh, multi_pod=multi_pod,
                         microbatches=microbatches)
        count = got["count"]
        total = got["argument_bytes"] + got["peak_bytes"]
        record.update({
            "status": "ok",
            "chips": chips,
            "mesh_note": MESH_NOTE,
            "kv_layout": (PS.kv_layout(M.kv_cache_dims(cfg)[0],
                                       mesh.shape["model"])
                          if M.attn_layer_count(cfg) else None),
            "memory_per_device": {
                "argument_bytes": got["argument_bytes"],
                "output_bytes": got["output_bytes"],
                "temp_bytes": max(got["peak_bytes"] - got["output_bytes"],
                                  0),
                "alias_bytes": 0,
                "total_bytes": total,
                "hbm_per_chip": hw.HBM_PER_CHIP,
                "fits": bool(total < hw.HBM_PER_CHIP),
            },
        })
        del got
        if roofline:
            cost = count.cost()
            mf = model_flops(cfg, shape)
            n_total, n_active = count_params(cfg)
            record["roofline"] = {
                "flops_per_device": cost.flops,
                "bytes_per_device": cost.bytes_hbm,
                "collective_bytes_per_device": cost.coll_bytes,
                "collective_breakdown": cost.coll_breakdown,
                "corrected": cost.corrected,
                **cost.terms(),
                "dominant": cost.dominant(),
                "model_flops": mf,
                "model_flops_per_device": mf / chips,
                "useful_flops_ratio": (mf / chips) / max(cost.flops, 1.0),
                "params_total": n_total,
                "params_active": n_active,
                "aten_flops": count.aten_flops,
                "aten_bytes": count.bytes,
                "kernels": {k: {"launches": v[0], "flops": v[1],
                                "bytes": v[2]}
                            for k, v in sorted(count.kernels.items())},
                "rates": _rates(),
                "method": "eager full-depth count",
            }
    record["wall_s"] = time.time() - t0
    _write(record, out_dir, fname)
    return record


def all_cells(mesh_kinds=("single", "multi")):
    for arch in ARCHS:
        for shape_name in SHAPES:
            for mk in mesh_kinds:
                yield arch, shape_name, mk


def summary(rec: dict) -> str:
    """One line of a record: status, memory, dominant term, useful
    share, wall time."""
    status = rec["status"] + ("" if rec["status"] != "skip"
                              else f" ({rec['reason']})")
    extra = ""
    mem = rec.get("memory_per_device")
    if mem:
        extra = (f" mem/dev={mem['total_bytes'] / 2**30:.2f}GiB"
                 f" fits={mem['fits']}")
    if "roofline" in rec:
        r = rec["roofline"]
        extra += (f" dom={r['dominant']}"
                  f" compute={r['compute_s']:.4g}s"
                  f" memory={r['memory_s']:.4g}s"
                  f" collective={r['collective_s']:.4g}s"
                  f" useful={r['useful_flops_ratio']:.2f}")
    if "wall_s" in rec:
        extra += f" wall={rec['wall_s']:.1f}s"
    return f"[{status}] {rec['arch']} {rec['shape']} {rec['mesh']}{extra}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None, choices=["single", "multi"])
    ap.add_argument("--no-roofline", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    args = ap.parse_args(argv)

    cells = [
        c for c in all_cells()
        if (args.arch is None or c[0] == args.arch)
        and (args.shape is None or c[1] == args.shape)
        and (args.mesh is None or c[2] == args.mesh)
    ]
    if args.list:
        for c in cells:
            print(*c)
        return
    failures = 0
    for arch, shape_name, mk in cells:
        fname = os.path.join(args.out, f"{arch}__{shape_name}__{mk}.json")
        if args.skip_existing and os.path.exists(fname):
            print(f"[cached] {arch} {shape_name} {mk}")
            continue
        try:
            rec = run_cell(arch, shape_name, mk,
                           roofline=not args.no_roofline, out_dir=args.out)
            print(summary(rec), flush=True)
        except Exception:
            failures += 1
            print(f"[FAIL] {arch} {shape_name} {mk}", flush=True)
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
