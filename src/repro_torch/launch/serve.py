"""Serving launcher: the packed engine fed by an open-loop synthetic
request stream (arrival-rate driven), reporting latency and throughput.

    python -m repro_torch.launch.serve --arch smollm-135m [--reduced] \
        [--device cpu] [--chunked-prefill] [--profile]

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
from repro_torch.kernels.paged_attention import kernel as K
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
                  seed=SEED, device=dev)
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
        K.reset_launches()
        prof = _profiler() if profile else contextlib.nullcontext()
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
    print(f"kernel launches: {dict(K.LAUNCHES)}")
    if args.profile:
        # the same requests again under the profiler (which slows the
        # host several-fold): device time by kernel, idle share against
        # the unprofiled wall time above
        *_, dt_prof, prof = run(prompts[1:], profile=True)
        _report(prof, dt, dt_prof)


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


def _profiler():
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def _report(prof, wall_s: float, prof_wall_s: float) -> None:
    """Device time by kernel (summed over launches) and the device's idle
    share of the unprofiled wall time (one stream: kernels never
    overlap)."""
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side op; its kernels are listed on their own
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = ev.self_cuda_time_total
        rows.append((t / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    if not busy_ms:
        raise RuntimeError("the profile recorded no device time")
    print(f"profile: device busy {busy_ms:.1f} ms; unprofiled wall "
          f"{wall_s * 1e3:.1f} ms, idle share {1 - busy_ms / (wall_s * 1e3):.3f}"
          f" (profiled wall {prof_wall_s * 1e3:.1f} ms)")
    for ms, n, key in rows[:16]:
        print(f"  {ms:9.2f} ms  {ms / busy_ms:6.1%}  x{n:<6d} {key[:90]}")


if __name__ == "__main__":
    main()
