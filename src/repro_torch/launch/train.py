"""Training launcher: AdamW steps of a dense, MoE (MLA included), hybrid
(zamba2) or ssm (xlstm) model on synthetic Markov data, on one device.

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
kernel and the device's idle share of the unprofiled step time.  One
device: no mesh and no sharding.
"""
from __future__ import annotations

import argparse
import signal
import time

import torch

from repro_torch import weights
from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.mamba2 import kernel as SK
from repro_torch.kernels.mlstm import kernel as MK
from repro_torch.launch.profiling import profiler, report
from repro_torch.training import checkpoint as C
from repro_torch.training.data import DataState, MarkovDataset
from repro_torch.training.trainer import (
    load_state_tensors, make_train_state, state_tensors, train_step,
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
    args = ap.parse_args(argv)
    if args.global_batch % args.microbatches:
        ap.error("--global-batch must be a multiple of --microbatches")
    dev = torch.device(args.device)
    if args.profile and dev.type != "cuda":
        ap.error("--profile measures device time: it needs --device cuda")

    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduced(cfg)
    model = weights.init_random(cfg, SEED, device=dev)
    ds = MarkovDataset(cfg.vocab_size, seed=1)
    start = C.latest_step(args.ckpt_dir) if args.ckpt_dir else None
    if start is not None:
        tensors, start, dstate = C.restore(args.ckpt_dir)
        state = load_state_tensors(model, tensors)
        print(f"resumed at step {start}")
    else:
        state = make_train_state(model)
        dstate = DataState(seed=1)
        start = 0

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

    for i in range(start, args.steps):
        batch = next_batch()
        t0 = time.perf_counter()
        state, m = train_step(model, state, batch, **step_kw)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])  # waits
        times.append(time.perf_counter() - t0)
        print(f"step {i} loss {loss:.4f} aux {float(m['aux']):.4f} gnorm "
              f"{gnorm:.4f} lr {float(m['lr']):.3e} ({times[-1] * 1e3:.1f} "
              f"ms)", flush=True)
        if args.ckpt_dir and ((i + 1) % args.ckpt_every == 0
                              or stop["now"] or i + 1 == args.steps):
            ckpt.save_async(args.ckpt_dir, state_tensors(model, state),
                            step=i + 1, data_state=dstate)
        if stop["now"]:
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
    print(f"trained {len(times)} steps of {cfg.name} ({cfg.num_layers} "
          f"layers, batch {args.global_batch} x seq {args.seq}) on {where}: "
          f"{tok_s:.1f} tokens/s over the last {len(timed)} steps, peak "
          f"memory {peak}, " + ", ".join(
              f"{what} kernel launches {mod.LAUNCHES[fn]} "
              f"{mod.KERNEL_LAUNCHES}" for what, mod, fn in (
                  ("flash", FK, "flash_attention_fwd"),
                  ("ssd", SK, "ssd_chunked_fwd"),
                  ("mlstm", MK, "mlstm_chunked_fwd"))))
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


if __name__ == "__main__":
    main()
