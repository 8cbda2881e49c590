"""Serving launcher: the engine fed by an open-loop synthetic request
stream (arrival-rate driven), reporting latency and throughput.

    python -m repro_torch.launch.serve --arch smollm-135m [--reduced] \
        [--device cpu] [--chunked-prefill] [--eager] [--profile]
    python -m repro_torch.launch.serve --arch zamba2-1.2b [--reduced] \
        [--device cpu] [--profile]
    python -m repro_torch.launch.serve --arch xlstm-350m [--reduced] \
        [--device cpu] [--profile]

A dense model runs the packed step; a hybrid model (zamba2) and an
xLSTM model (xlstm) run the padded per-kind step.  On the card the packed
step and the padded decode step are captured into CUDA graphs and
replayed (`--eager`: `Engine(cuda_graphs=False)`, every step eager); the
run prints its `compile_events` (one per executable-cache key) and its
captures and replays.
Runs on the GPU (`cuda`) unless `--device cpu` is given.  Weights and
prompts are random, drawn from seed 0; prompt lengths are uniform in
[--min-prompt, --max-prompt].  `--profile` runs the measured loop under
`torch.profiler` a second time and prints device time by kernel and the
device's idle share of the unprofiled wall time.  One warm-up request on
a throwaway engine runs first.
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from repro_torch import weights
from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.mamba2 import kernel as SK
from repro_torch.kernels.mlstm import kernel as MK
from repro_torch.kernels.paged_attention import kernel as K
from repro_torch.launch.profiling import profiler, report
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request, State

SEED = 0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--num-requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=8.0,
                    help="arrivals per engine step")
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--max-seqs", type=int, default=8)
    ap.add_argument("--num-pages", type=int, default=256)
    ap.add_argument("--max-model-len", type=int, default=512)
    ap.add_argument("--min-prompt", type=int, default=8)
    ap.add_argument("--max-prompt", type=int, default=79)
    ap.add_argument("--chunked-prefill", action="store_true")
    ap.add_argument("--max-prefill-tokens", type=int, default=8192)
    ap.add_argument("--eager", action="store_true",
                    help="no CUDA graphs: every step runs eagerly")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()

    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduced(cfg)
    dev = torch.device(args.device)
    if args.profile and dev.type != "cuda":
        ap.error("--profile measures device time: it needs --device cuda")
    model = weights.init_random(cfg, SEED, device=dev)
    eng_kw = dict(max_seqs=args.max_seqs, num_pages=args.num_pages,
                  max_model_len=args.max_model_len,
                  enable_chunked_prefill=args.chunked_prefill,
                  max_prefill_tokens=args.max_prefill_tokens,
                  cuda_graphs=not args.eager, seed=SEED, device=dev)
    rng = np.random.default_rng(SEED)
    prompts = [list(map(int, rng.integers(
        1, cfg.vocab_size,
        size=int(rng.integers(args.min_prompt, args.max_prompt + 1)))))
        for _ in range(args.num_requests + 1)]

    def run(prompts: list[list[int]], profile: bool = False):
        eng = Engine(cfg, model, **eng_kw)
        reqs = [Request(prompt=list(p), max_new_tokens=args.max_new_tokens)
                for p in prompts]
        t_submit: dict[int, float] = {}
        t_done: dict[int, float] = {}
        for kernels in (K, FK, SK, MK):
            kernels.reset_launches()
        prof = profiler() if profile else contextlib.nullcontext()
        t0 = time.perf_counter()
        with prof:
            _drive(eng, list(reqs), args.rate, t_submit, t_done)
        return eng, reqs, t_submit, t_done, time.perf_counter() - t0, prof

    run(prompts[:1])  # warm-up on a throwaway engine: handles, allocator
    eng, reqs, t_submit, t_done, dt, _ = run(prompts[1:])
    lat = np.asarray([t_done[i] - t_submit[i] for i in t_submit])
    total_toks = sum(len(r.output) for r in reqs)
    prompt_toks = sum(r.num_prompt_tokens for r in reqs)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "the CPU")
    print(f"served {len(reqs)} requests / {prompt_toks} prompt + "
          f"{total_toks} new tokens in {dt:.3f}s ({total_toks / dt:.1f} new "
          f"tok/s on {where}) in {eng.step_idx} steps")
    print(f"latency p50={np.percentile(lat, 50):.3f}s "
          f"p95={np.percentile(lat, 95):.3f}s max={lat.max():.3f}s")
    print(f"dispatch: {dict(eng.dispatch_counts)}")
    print(f"device calls: {dict(eng.device_calls)}")
    print(f"kernel launches: "
          f"{K.LAUNCHES | FK.LAUNCHES | SK.LAUNCHES | MK.LAUNCHES}")
    gs = eng.graph_stats
    print(f"compile_events: {len(eng.compile_events)}  cuda graphs: "
          f"{gs['captures']} captured ({gs['capture_s']:.3f}s capturing), "
          f"{gs['replays']} replays")
    if args.profile:
        # the same requests again under the profiler (which slows the
        # host several-fold): device time by kernel, idle share against
        # the unprofiled wall time above
        *_, dt_prof, prof = run(prompts[1:], profile=True)
        report(prof, dt, dt_prof)


def _drive(eng, pending, rate, t_submit, t_done) -> None:
    all_reqs = list(pending)
    arrivals = 0.0
    while pending or eng.sched.has_work:
        arrivals += rate
        while pending and arrivals >= 1.0:
            r = pending.pop(0)
            t_submit[r.req_id] = time.perf_counter()
            eng.add_request(r)
            arrivals -= 1.0
        eng.step()  # returns after the step's tokens reached the host
        now = time.perf_counter()
        for r in all_reqs:
            if r.state is State.FINISHED and r.req_id not in t_done:
                t_done[r.req_id] = now


if __name__ == "__main__":
    main()
