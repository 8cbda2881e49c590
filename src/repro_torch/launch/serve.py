"""Serving launcher: the engine fed by an open-loop synthetic request
stream (arrival-rate driven), reporting latency and throughput.

    python -m repro_torch.launch.serve --arch smollm-135m [--reduced] \
        [--device cpu] [--chunked-prefill] [--eager] [--profile] \
        [--stream] [--prefix-caching] [--shared-prefix N] \
        [--speculative [--draft-k K]] [--no-fused-sampling]
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
`--stream` submits every request up front and drives the engine through
`submit()` + `run()`, the async double-buffered loop on the packed step
(the padded step steps synchronously under it); without it the requests
arrive `--rate` per step into `step()` calls.  `--prefix-caching` turns
on the prefix cache (dense models only); `--shared-prefix N` prepends
one N-token prompt to every request, the cache's hot path.
`--speculative` verifies per-request n-gram drafts (up to `--draft-k`
a step) in the packed launch and prints the drafts' stats;
`--no-fused-sampling` samples in a second dispatch after the packed
launch (dense models only, like both).
Runs on the GPU (`cuda`) unless `--device cpu` is given.  Weights and
prompts are random, drawn from seed 0; prompt lengths (after the shared
prefix) are uniform in [--min-prompt, --max-prompt].  The default
--max-model-len is the power of two (at least 512) that holds the
longest request, and the default --num-pages gives every slot that
length.  `--profile` runs the measured loop under
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
from repro_torch.utils.misc import cdiv, next_power_of_2

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
    ap.add_argument("--num-pages", type=int, default=None)
    ap.add_argument("--max-model-len", type=int, default=None)
    ap.add_argument("--min-prompt", type=int, default=8)
    ap.add_argument("--max-prompt", type=int, default=79)
    ap.add_argument("--chunked-prefill", action="store_true")
    ap.add_argument("--max-prefill-tokens", type=int, default=8192)
    ap.add_argument("--eager", action="store_true",
                    help="no CUDA graphs: every step runs eagerly")
    ap.add_argument("--stream", action="store_true",
                    help="drive through submit() + run(): the async "
                         "double-buffered loop")
    ap.add_argument("--prefix-caching", action="store_true",
                    help="reuse cached KV pages of shared prompt prefixes")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="N",
                    help="prepend one N-token prompt to every request")
    ap.add_argument("--no-fused-sampling", action="store_true",
                    help="sample the packed launch's logits in a second "
                         "dispatch (two device calls a step)")
    ap.add_argument("--speculative", action="store_true",
                    help="speculative decoding: per-request n-gram drafts "
                         "verified in the one packed launch, exact page "
                         "rollback on rejection; tokens identical to the "
                         "plain path")
    ap.add_argument("--draft-k", type=int, default=4, metavar="K",
                    help="most drafts proposed per request per step "
                         "(adaptive from the accept rate; default 4)")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()

    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduced(cfg)
    dev = torch.device(args.device)
    if args.profile and dev.type != "cuda":
        ap.error("--profile measures device time: it needs --device cuda")
    longest = args.shared_prefix + args.max_prompt + args.max_new_tokens
    max_model_len = args.max_model_len or max(512, next_power_of_2(longest))
    num_pages = args.num_pages or \
        args.max_seqs * cdiv(max_model_len, cfg.page_size)
    model = weights.init_random(cfg, SEED, device=dev)
    eng_kw = dict(max_seqs=args.max_seqs, num_pages=num_pages,
                  max_model_len=max_model_len,
                  enable_prefix_caching=args.prefix_caching,
                  enable_chunked_prefill=args.chunked_prefill,
                  max_prefill_tokens=args.max_prefill_tokens,
                  fused_sampling=not args.no_fused_sampling,
                  speculative=args.speculative, draft_k=args.draft_k,
                  cuda_graphs=not args.eager, seed=SEED, device=dev)
    rng = np.random.default_rng(SEED)
    shared = list(map(int, rng.integers(1, cfg.vocab_size,
                                        size=args.shared_prefix)))
    prompts = [shared + list(map(int, rng.integers(
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
        drive = _drive_stream if args.stream else _drive
        t0 = time.perf_counter()
        with prof:
            drive(eng, list(reqs), args.rate, t_submit, t_done)
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
    print(f"drive: {'submit() + run()' if args.stream else 'step()'}  "
          f"prefilled_tokens {eng.prefilled_tokens}  cached_prefill_tokens "
          f"{eng.cached_prefill_tokens}")
    if eng.prefix_cache is not None:
        print(f"prefix cache: {eng.prefix_cache.stats()}")
    print(f"dispatch: {dict(eng.dispatch_counts)}")
    print(f"device calls: {dict(eng.device_calls)}")
    if args.speculative:
        st = eng.spec_stats
        rate = st["accepted"] / st["proposed"] if st["proposed"] else 0.0
        k = eng.drafter.controller.k if eng.drafter is not None else 0
        print(f"speculative decoding: {st['proposed']} drafted, "
              f"{st['accepted']} accepted ({rate:.1%}), "
              f"{st['emitted']} emitted over {st['steps']} spec steps "
              f"(adaptive k now {k})")
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


def _drive_stream(eng, pending, rate, t_submit, t_done) -> None:
    """Every request submitted at once, then `run()` to the end (`rate`
    does not apply)."""
    del rate
    for r in pending:
        t_submit[r.req_id] = time.perf_counter()
        eng.submit(r)
    out = eng.run(on_finish=lambda r: t_done.setdefault(
        r.req_id, time.perf_counter()))
    if out["unfinished"]:
        raise RuntimeError(f"run() ended with {out['unfinished']} "
                           "request(s) unfinished")


if __name__ == "__main__":
    main()
