"""Training launcher: AdamW steps of a dense, MoE (MLA included), hybrid
(zamba2) or ssm (xlstm) model on synthetic Markov data, on one device
or on a (data, model) mesh of ranks.

    python -m repro_torch.launch.train --arch smollm-135m [--reduced] \
        [--device cpu] [--steps N] [--global-batch B] [--seq S] \
        [--microbatches M] [--ckpt-dir DIR --ckpt-every K] [--profile]

Runs on the GPU (`cuda`) unless `--device cpu` is given.  Weights are
random from seed 0; the data is `MarkovDataset(vocab, seed=1)`.  Prints
`step i loss ... aux ... gnorm ...` per step (aux: the MoE blocks'
load-balance loss, inside the loss), then a summary line with tokens/s
(over the steps after the first, which also builds the kernels), the
peak device memory and the launches of the flash, SSD and mLSTM kernels
(each wrapper's count, and by device kernel).  With --ckpt-dir it
resumes from the latest checkpoint there, saves asynchronously every
--ckpt-every steps and at the end, and on SIGTERM saves once more and
exits.  `--profile` then
runs two more steps under `torch.profiler` and prints device time by
kernel and the device's idle share of the unprofiled step time.

`--mesh DxM` (default 1x1: the one-device path above) trains on a
(data D, model M) mesh of D x M ranks, as the reference's launcher
does: the rules `make_rules(fsdp=SH.uses_fsdp(cfg), sp=True)`,
every parameter and its moments placed by `param_spec`, the global batch
split by `batch_spec`.  `--multi-pod` takes the reference's (pod 2, data
16, model 16) production mesh instead (512 ranks).  The ranks come from

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch A \
        --mesh 2x2 --backend gloo [--device cpu]

(or from `launch.mesh.spawn_ranks` calling `main(argv)` in each rank of
an initialised world).  The backend is the caller's choice, never
switched: "gloo" for CPU ranks or ranks sharing one card, "nccl" for a
card a rank (under torchrun, rank r takes card LOCAL_RANK mod the
cards).  One loop serves both: rank 0 (the only rank on one device)
prints the step lines and the summary; on a mesh every rank also prints
its peak memory and its share of the parameters.  A checkpoint of a mesh
run holds whole tensors (every rank gathers, rank 0 writes, before the
next step) and restores onto any mesh, one device included.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import signal
import time

import torch
import torch.distributed as dist

from repro_torch import weights
from repro_torch.configs import ARCHS, reduced
from repro_torch.core.paged.kv_cache import ShardingError
from repro_torch.distributed import param_sharding as PS
from repro_torch.distributed import sharding as SH
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.mamba2 import kernel as SK
from repro_torch.kernels.mlstm import kernel as MK
from repro_torch.launch.profiling import profiler, report
from repro_torch.training import checkpoint as C
from repro_torch.training.data import DataState, MarkovDataset
from repro_torch.launch import mesh as mesh_mod
from repro_torch.training.trainer import (
    load_state_tensors, make_train_state, place_train_state, state_tensors,
    train_step, whole_state_tensors,
)

SEED = 0


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--mesh", default="1x1",
                    help="DxM: data x model ranks (1x1: one device)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (2, 16, 16) production mesh")
    ap.add_argument("--backend", choices=("gloo", "nccl"),
                    help="the process group's backend on a mesh")
    args = ap.parse_args(argv)
    if args.global_batch % args.microbatches:
        ap.error("--global-batch must be a multiple of --microbatches")
    try:
        shape = tuple(int(n) for n in args.mesh.lower().split("x"))
    except ValueError:
        shape = ()
    if len(shape) != 2 or min(shape) < 1:
        ap.error(f"--mesh {args.mesh!r}: expected DxM, e.g. 2x2")
    if args.profile and torch.device(args.device).type != "cuda":
        ap.error("--profile measures device time: it needs --device cuda")

    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduced(cfg)
    on_mesh = shape != (1, 1) or args.multi_pod
    if on_mesh and args.profile:
        ap.error("--profile runs on one device (--mesh 1x1)")
    dev = _mesh_world(args) if on_mesh else torch.device(args.device)
    rank = dist.get_rank() if on_mesh else 0
    mesh = rules = None
    fsdp = SH.uses_fsdp(cfg)
    if on_mesh:
        if args.multi_pod:
            mesh = mesh_mod.make_production_mesh(multi_pod=True,
                                                 device_type=dev.type)
        else:
            mesh = mesh_mod.make_mesh(shape, ("data", "model"),
                                      device_type=dev.type)
        rules = SH.make_rules(multi_pod=args.multi_pod, fsdp=fsdp, sp=True)
    model = weights.init_random(cfg, SEED, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    ds = MarkovDataset(cfg.vocab_size, seed=1)
    start = C.latest_step(args.ckpt_dir) if args.ckpt_dir else None
    if start is not None:  # whole tensors, placed onto the mesh if any
        tensors, start, dstate = C.restore(args.ckpt_dir)
        state = load_state_tensors(model, tensors)
        del tensors
        if on_mesh:
            place_train_state(model, state, mesh=mesh, fsdp=fsdp,
                              batch_axes=rules["batch"])
        if rank == 0:
            print(f"resumed at step {start}")
    else:  # placed first: the moments are made at the blocks' size
        if on_mesh:
            PS.assign_param_shardings(model, mesh=mesh, fsdp=fsdp,
                                      batch_axes=rules["batch"])
        state = make_train_state(model)
        dstate = DataState(seed=1)
        start = 0
    n_local = sum(p.numel() for p in model.parameters())

    ckpt = C.AsyncCheckpointer()
    stop = {"now": False}

    def _sigterm(_sig, _frm):  # preemption notice -> final checkpoint
        stop["now"] = True

    signal.signal(signal.SIGTERM, _sigterm)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for mod in (FK, SK, MK):
        mod.reset_launches()
    step_kw = dict(base_lr=args.lr, warmup=20, total_steps=args.steps,
                   microbatches=args.microbatches)
    times = []

    def next_batch():
        nonlocal dstate
        batch, dstate = ds.batch(dstate, batch_size=args.global_batch,
                                 seq_len=args.seq)
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    def save(step):
        if not on_mesh:
            ckpt.save_async(args.ckpt_dir, state_tensors(model, state),
                            step=step, data_state=dstate)
            return
        whole = whole_state_tensors(model, state)  # every rank gathers
        if rank == 0:
            C.save(args.ckpt_dir, whole, step=step, data_state=dstate)
        del whole
        dist.barrier()

    with SH.use_rules(mesh, rules) if on_mesh else contextlib.nullcontext():
        for i in range(start, args.steps):
            batch = next_batch()
            t0 = time.perf_counter()
            state, m = train_step(model, state, batch, **step_kw)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])  # waits
            times.append(time.perf_counter() - t0)
            if rank == 0:
                print(f"step {i} loss {loss:.4f} aux {float(m['aux']):.4f} "
                      f"gnorm {gnorm:.4f} lr {float(m['lr']):.3e} "
                      f"({times[-1] * 1e3:.1f} ms)", flush=True)
            if args.ckpt_dir and ((i + 1) % args.ckpt_every == 0
                                  or stop["now"] or i + 1 == args.steps):
                save(i + 1)
            if stop["now"]:
                if rank == 0:
                    print("preemption signal: checkpointed, exiting")
                break
    ckpt.wait()
    if not times:
        return
    timed = times[1:] or times
    tok_s = args.global_batch * args.seq * len(timed) / sum(timed)
    if dev.type == "cuda":
        where = torch.cuda.get_device_name(dev)
        peak = f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
    else:
        where, peak = "the CPU", "not measured on the CPU"
    if on_mesh:
        where = (f"a {'x'.join(str(mesh.shape[a]) for a in mesh.axis_names)}"
                 f" mesh {mesh.axis_names} of {mesh.world} ranks (fsdp "
                 f"{fsdp}, {dist.get_backend()}) on {where}")
    if rank == 0:
        print(f"trained {len(times)} steps of {cfg.name} ({cfg.num_layers} "
              f"layers, batch {args.global_batch} x seq {args.seq}) on "
              f"{where}: {tok_s:.1f} tokens/s over the last {len(timed)} "
              f"steps, peak memory {peak}, " + ", ".join(
                  f"{what} kernel launches {mod.LAUNCHES[fn]} "
                  f"{mod.KERNEL_LAUNCHES}" for what, mod, fn in (
                      ("flash", FK, "flash_attention_fwd"),
                      ("ssd", SK, "ssd_chunked_fwd"),
                      ("mlstm", MK, "mlstm_chunked_fwd"))), flush=True)
    if on_mesh:
        print(f"rank {rank} {dict(mesh.coord)}: peak memory {peak}, "
              f"parameters held {n_local} of {n_params} "
              f"({n_local / n_params:.4f})", flush=True)
    if args.profile:
        n = 2
        batches = [next_batch() for _ in range(n)]
        prof = profiler()
        t0 = time.perf_counter()
        with prof:
            for batch in batches:
                state, m = train_step(model, state, batch, **step_kw)
                float(m["loss"])
        report(prof, n * sum(timed) / len(timed), time.perf_counter() - t0)


def _mesh_world(args):
    """The initialised world and this rank's device: an existing world
    (spawn_ranks), or one from torchrun's environment with the backend
    the caller named."""
    if not dist.is_initialized():
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise ShardingError(
                f"--mesh {args.mesh} trains on several ranks: start them "
                f"with `torchrun --nproc-per-node N -m repro_torch.launch."
                f"train ... --backend gloo|nccl`, or call main() in each "
                f"rank of a world that launch.mesh.spawn_ranks started")
        if args.backend is None:
            raise ShardingError("--backend gloo|nccl is needed to start "
                                "the world: gloo for CPU ranks or ranks "
                                "sharing one card, nccl for a card a rank")
        dist.init_process_group(args.backend)
    dev = torch.device(args.device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", 0))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


if __name__ == "__main__":
    main()
