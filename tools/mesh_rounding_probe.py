"""How far fp32 rounding alone moves the recurrent families' gradient
leaves, beside how far the (data, model) mesh moves them.  Run on an
H100 (four gloo ranks share the card):

    PYTHONPATH=src python tools/mesh_rounding_probe.py [--depths 2,4,8]

(`--cpu`: a rehearsal at the reduced widths on the CPU.)

`chip_smoke.py` phase 28 (c) holds every gradient leaf of zamba2-1.2b and
xlstm-350m (full width, cut in depth, fp32, 4 x 256 Markov tokens, two
steps) on the (data 2, model 2) mesh against one device's, relative to
the leaf's largest element.  The mesh computes the same function in
another summation order: the data ranks sum halves of the batch, the
model ranks sum partial products of the row-parallel layers.  This script
measures, for each architecture and depth, every leaf's error against
one device's plain step (`microbatches=1`) of

- two one-device witnesses that change only the summation order: the
  same batch in two microbatches (the gradient summed over the two
  halves, as the data ranks sum it), and the batch's rows reversed (every
  sum over the batch taken in the other order);
- the mesh at (2, 2) (phase 28 (c)'s), (4, 1) (data only) and (1, 4)
  (model only: a head a rank for xlstm).

Each line gives the worst leaf and its error, and the errors of the
leaves that bind phase 28 (c).  Where the witnesses reach the mesh's
error at every depth, rounding is what the mesh's error is.  The card's
name and power limit come first; the table also goes to
`chiprun_out/mesh_rounding_probe.json`.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import chip_smoke as CS  # noqa: E402

ARCHS = ("xlstm-350m", "zamba2-1.2b")
MESHES = ((2, 2), (4, 1), (1, 4))
BATCH, SEQ, STEPS = 4, 256, 2
# the leaves that bound phase 28 (c)'s xlstm on the card (PR 31's call 1)
WATCH = ("embed", "mlstm.0.out_proj.w", "mlstm.2.wq.w")


def _grads(torch, cfg, batches, **kw):
    """One device's complete gradients of each step ({name: tensor})."""
    from repro_torch import weights
    from repro_torch.training import trainer as T

    model = weights.init_random(cfg, CS.SEED, device=CS.DEVICE,
                                on_device=True)
    names = [n for n, _ in model.named_parameters()]
    out = []

    def keep(step, grads):
        out.append({n: g.detach().clone() for n, g in zip(names, grads)})

    CS.mesh_steps(torch, model, T.make_train_state(model), batches, keep,
                  kw=dict(CS.MESH_KW, **kw))
    return out


def _errors(got, want, whole=None) -> dict:
    """{leaf: max over steps of max |got - want| over the largest element
    of the whole leaf (`whole`'s, where `want` holds this rank's blocks of
    it)}."""
    err = {}
    for i, (g, w) in enumerate(zip(got, want)):
        for n, t in w.items():
            top = max(float((whole or want)[i][n].abs().max()), 1e-30)
            e = float((g[n] - t).abs().max()) / top
            err[n] = max(err.get(n, 0.0), e)
    return err


def probe_rank(rank, world, depths, cpu):
    import torch
    import torch.distributed as dist

    from repro_torch import weights
    from repro_torch.configs import ARCHS as REG, reduced
    from repro_torch.distributed import param_sharding as PS
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import trainer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    if cpu:  # the rehearsal: reduced widths on the CPU
        CS.DEVICE = "cpu"
        torch.cuda.synchronize = lambda: None  # mesh_steps' wall clock
    else:
        torch.cuda.set_device(0)
    meshes = {shape: make_mesh(shape, ("data", "model"),
                               device_type=CS.DEVICE) for shape in MESHES}
    rows = []
    for arch in ARCHS:
        for depth in depths:
            t0 = time.perf_counter()
            cfg = (reduced(REG[arch]) if cpu else REG[arch]).replace(
                num_layers=depth, dtype="float32")
            batches = CS.mesh_batches(cfg, STEPS, BATCH, SEQ)
            plain = _grads(torch, cfg, batches)
            errs = {f"microbatches {n}": _errors(
                _grads(torch, cfg, batches, microbatches=n), plain)
                for n in (2, 4)}
            rev = [{k: v[::-1].copy() for k, v in b.items()}
                   for b in batches]
            errs["rows reversed"] = _errors(_grads(torch, cfg, rev), plain)
            rules = SH.make_rules(fsdp=True, sp=True)
            for shape, mesh in meshes.items():
                model = weights.init_random(cfg, CS.SEED, device=CS.DEVICE,
                                            on_device=True)
                names = [n for n, _ in model.named_parameters()]
                layouts = PS.param_layouts(model, mesh_shape=mesh.shape,
                                           fsdp=True,
                                           batch_axes=rules["batch"])
                PS.assign_param_shardings(model, mesh=mesh, fsdp=True,
                                          batch_axes=rules["batch"])
                got = []

                def keep(step, grads):
                    got.append({n: g.detach().clone()
                                for n, g in zip(names, grads)})

                with SH.use_rules(mesh, rules):
                    CS.mesh_steps(torch, model, T.make_train_state(model),
                                  batches, keep)
                cut = [{n: PS.cut_block(t, layouts[n], mesh)
                        for n, t in p.items()} for p in plain]
                errs[f"mesh {shape[0]}x{shape[1]}"] = _errors(got, cut,
                                                               plain)
                del model, got, cut
                dist.barrier()
            for what, e in errs.items():
                worst = max(e, key=e.get)
                rows.append(dict(arch=arch, depth=depth, what=what,
                                 worst_leaf=worst, worst=e[worst],
                                 watch={n: e[n] for n in WATCH if n in e},
                                 errors=e))
            del plain
            if not cpu:
                torch.cuda.empty_cache()
            if rank == 0:
                print(f"{arch} {depth} layers: {time.perf_counter() - t0:.1f}"
                      f"s", flush=True)
    return rows


def main(argv=None) -> int:
    import torch

    from repro_torch.launch.mesh import spawn_ranks

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--depths", default="2,4,8")
    ap.add_argument("--cpu", action="store_true",
                    help="a rehearsal at the reduced widths on the CPU")
    args = ap.parse_args(argv)
    if not (args.cpu or torch.cuda.is_available()):
        print("mesh_rounding_probe: no CUDA device", file=sys.stderr)
        return 2
    depths = [int(d) for d in args.depths.split(",")]
    smi = "cpu" if args.cpu else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"nvidia-smi {smi}", flush=True)
    store = ROOT / "build" / "rounding_probe"
    store.mkdir(parents=True, exist_ok=True)
    (store / "store").unlink(missing_ok=True)
    res = spawn_ranks(probe_rank, CS.MESH_RANKS, backend="gloo",
                      init_file=str(store / "store"), args=(depths, args.cpu))
    table = []
    for r, rows in enumerate(res):
        for row in rows:
            table.append(dict(row, rank=r))
    # the worst rank of each (arch, depth, what)
    best = {}
    for row in table:
        key = (row["arch"], row["depth"], row["what"])
        if key not in best or row["worst"] > best[key]["worst"]:
            best[key] = row
    for (arch, depth, what), row in best.items():
        watch = " ".join(f"{n} {e:.2e}" for n, e in row["watch"].items())
        # the witnesses' error on the leaf the 2 x 2 mesh binds
        mesh = best[(arch, depth, "mesh 2x2")]
        leaf = mesh["worst_leaf"]
        there = row["errors"].get(leaf, float("nan")) \
            if row["rank"] == mesh["rank"] else max(
                r["errors"][leaf] for r in table
                if (r["arch"], r["depth"], r["what"]) == (arch, depth, what))
        print(f"{arch:12s} {depth} layers {what:15s}: worst "
              f"{row['worst']:.2e} ({row['worst_leaf']}, rank {row['rank']})"
              f"; at 2x2's worst leaf {leaf} {there:.2e};  {watch}",
              flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "mesh_rounding_probe.json").write_text(json.dumps(
        dict(device=smi, batch=BATCH, seq=SEQ, steps=STEPS, rows=table),
        indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
