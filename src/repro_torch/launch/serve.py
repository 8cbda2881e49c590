"""Serving launcher: the engine fed by an open-loop synthetic request
stream (arrival-rate driven), reporting latency and throughput.

    python -m repro_torch.launch.serve --arch smollm-135m [--reduced] \
        [--device cpu] [--chunked-prefill] [--eager] [--profile] \
        [--stream] [--prefix-caching] [--shared-prefix N] \
        [--speculative [--draft-k K]] [--no-fused-sampling] \
        [--heuristics TREE.json|tune] [--max-prefill-tokens N|auto] \
        [--metrics-dir D] [--trace-out T] [--metrics-port P] \
        [--snapshot-interval SEC] [--slo-p95 SEC] [--refit-every N]
    python -m repro_torch.launch.serve --arch llama4-maverick-400b-a17b \
        --reduced [--device cpu] [--chunked-prefill] [...]
    python -m repro_torch.launch.serve --arch deepseek-v2-236b --reduced \
        [--device cpu]
    python -m repro_torch.launch.serve --arch zamba2-1.2b [--reduced] \
        [--device cpu] [--profile]
    python -m repro_torch.launch.serve --arch xlstm-350m [--reduced] \
        [--device cpu] [--profile]

A dense or MoE model runs the packed step (a MoE model's experts on the
grouped expert GEMM; llama4-maverick fits the card only `--reduced`, its
full width is served by `chip_smoke.py` at 2 layers); an MLA model
(deepseek-v2: its latent decode kernel, its prefill on the flash forward
at key width nope + rope; full width in `chip_smoke.py` at 8 layers), a
hybrid model (zamba2) and an xLSTM model (xlstm) run the padded per-kind
step.  On the card the packed
step and the padded decode step are captured into CUDA graphs and
replayed (`--eager`: `Engine(cuda_graphs=False)`, every step eager); the
run prints its `compile_events` (one per executable-cache key) and its
captures and replays.
`--stream` submits every request up front and drives the engine through
`submit()` + `run()`, the async double-buffered loop on the packed step
(the padded step steps synchronously under it); without it the requests
arrive `--rate` per step into `step()` calls.  `--prefix-caching` turns
on the prefix cache (dense and MoE models only); `--shared-prefix N` prepends
one N-token prompt to every request, the cache's hot path.
`--speculative` verifies per-request n-gram drafts (up to `--draft-k`
a step) in the packed launch and prints the drafts' stats;
`--no-fused-sampling` samples in a second dispatch after the packed
launch (dense and MoE models only, like both).
Kernel configs: the engine's built-in decision trees unless
`--heuristics TREE.json` (from `python -m repro_torch.launch.autotune`)
or $REPRO_ATTN_HEURISTICS names a tree; `--heuristics tune` runs a quick
cost-model tune inline first (the reference launcher's default).
`--max-prefill-tokens auto` takes the loaded tree's chunk budget, else
the cost model's.  Observability (the measured run only; metric names as
in docs/observability.md): `--metrics-dir D` writes D/metrics.prom,
D/metrics.jsonl and D/latency_grid.json (the input of `launch.autotune
--refit-from`); `--trace-out T` a Chrome / Perfetto trace;
`--metrics-port P` serves /metrics, /snapshot and /trace on 127.0.0.1:P
while the engine runs (0: an ephemeral port; `--snapshot-interval`
rotates snapshots into D); `--slo-p95 SEC` arms the flight recorder;
`--refit-every N` the online refit daemon, which hot-swaps refit trees
between steps.  Any of them turns on telemetry and prints its summary.
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
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import weights
from repro_torch.configs import ARCHS, reduced
from repro_torch.core.attention import heuristics
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.mamba2 import kernel as SK
from repro_torch.kernels.mla_decode import kernel as AK
from repro_torch.kernels.mlstm import kernel as MK
from repro_torch.kernels.moe import kernel as GK
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
    ap.add_argument("--max-prefill-tokens", type=_budget, default=8192,
                    metavar="N|auto",
                    help="per-step prefill token budget; auto: the loaded "
                         "tree's exported budget, else the cost model's "
                         "decode-latency roofline")
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
    ap.add_argument("--heuristics", default=None, metavar="TREE.json|tune",
                    help="decision trees exported by `python -m "
                         "repro_torch.launch.autotune` ($REPRO_ATTN_"
                         "HEURISTICS works too); `tune`: run a quick "
                         "cost-model tune inline; default: the engine's "
                         "built-in trees")
    ap.add_argument("--metrics-dir", default=None, metavar="DIR",
                    help="telemetry: write DIR/metrics.prom, "
                         "DIR/metrics.jsonl and DIR/latency_grid.json")
    ap.add_argument("--trace-out", default=None, metavar="TRACE.json",
                    help="telemetry: write a Chrome / Perfetto trace")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="P",
                    help="telemetry: serve /metrics, /snapshot and /trace "
                         "on 127.0.0.1:P while the engine runs (0: an "
                         "ephemeral port); snapshots rotate into "
                         "--metrics-dir")
    ap.add_argument("--snapshot-interval", type=float, default=30.0,
                    metavar="SEC",
                    help="snapshot cadence of the --metrics-port server")
    ap.add_argument("--slo-p95", type=float, default=None, metavar="SEC",
                    help="flight recorder: dump the trace ring and a "
                         "snapshot into --metrics-dir (or .) when the "
                         "rolling p95 step latency passes SEC")
    ap.add_argument("--refit-every", type=int, default=None, metavar="N",
                    help="online refit: after N new warm launches per "
                         "(phase, profile) bucket, refit the trees from "
                         "the latency grid and hot-swap them between "
                         "steps (files in --metrics-dir or .)")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    try:
        _serve(ap, args)
    finally:
        heuristics.reset()


def _budget(value: str) -> int | str:
    return value if value == "auto" else int(value)


def _load_heuristics(args, cfg) -> None:
    """Install the run's decision trees (see `--heuristics`)."""
    if args.heuristics == "tune":
        from repro_torch.autotune.tune import tune_and_export
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "tree.json")
            rep = tune_and_export(path, num_q_heads=cfg.num_q_heads,
                                  num_kv_heads=cfg.num_kv_heads,
                                  head_dim=cfg.resolved_head_dim,
                                  page_size=cfg.page_size)
            heuristics.load(path)
        print(f"heuristics: a cost-model tune (tuned-vs-fixed speedup "
              f"{rep['tuned_vs_untuned_speedup']:.2f}x)")
    elif args.heuristics:
        heuristics.load(args.heuristics)
        print(f"heuristics installed from {args.heuristics}")
    elif heuristics.maybe_load_env():
        print(f"heuristics installed from $REPRO_ATTN_HEURISTICS "
              f"({heuristics.loaded_path()})")


def _observers(args):
    """(telemetry, metrics server, refit daemon) of the measured run, each
    None when no flag asks for it."""
    from repro_torch.obs import (
        FlightRecorder, MetricsServer, RefitDaemon, Telemetry,
    )

    if not (args.metrics_dir or args.trace_out
            or args.metrics_port is not None
            or args.slo_p95 is not None or args.refit_every is not None):
        return None, None, None
    obs_dir = args.metrics_dir or "."
    # ring mode: the flight recorder wants the LAST steps at a breach;
    # the refit daemon wants every warm launch timed
    tel = Telemetry(trace_ring=args.slo_p95 is not None,
                    launch_timing_interval=1 if args.refit_every else 8)
    server = daemon = None
    if args.metrics_port is not None:
        server = MetricsServer(
            tel, port=args.metrics_port, snapshot_dir=args.metrics_dir,
            snapshot_interval_s=args.snapshot_interval,
            arch=args.arch).start()
        print(f"live metrics: {server.url()}")
    if args.slo_p95 is not None:
        FlightRecorder(tel, slo_p95_s=args.slo_p95, dump_dir=obs_dir)
    if args.refit_every is not None:
        daemon = RefitDaemon(tel, out_dir=obs_dir, min_new=args.refit_every)
    return tel, server, daemon


def _serve(ap, args) -> None:
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
    _load_heuristics(args, cfg)
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

    def run(prompts: list[list[int]], profile: bool = False, tel=None,
            daemon=None):
        eng = Engine(cfg, model, telemetry=tel, refit=daemon, **eng_kw)
        reqs = [Request(prompt=list(p), max_new_tokens=args.max_new_tokens)
                for p in prompts]
        t_submit: dict[int, float] = {}
        t_done: dict[int, float] = {}
        for kernels in (K, FK, SK, MK, GK):
            kernels.reset_launches()
        prof = profiler() if profile else contextlib.nullcontext()
        drive = _drive_stream if args.stream else _drive
        t0 = time.perf_counter()
        with prof:
            drive(eng, list(reqs), args.rate, t_submit, t_done)
        return eng, reqs, t_submit, t_done, time.perf_counter() - t0, prof

    run(prompts[:1])  # warm-up on a throwaway engine: handles, allocator
    tel, server, daemon = _observers(args)
    try:
        eng, reqs, t_submit, t_done, dt, _ = run(prompts[1:], tel=tel,
                                                 daemon=daemon)
    finally:
        # the artifacts of a cut run are what one refits or debugs from
        if server is not None:
            server.stop()
        if tel is not None:
            _export(args, tel)
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
    launches = {}
    for kernels in (K, FK, SK, MK, GK, AK):
        launches |= kernels.LAUNCHES
    print(f"kernel launches: {launches}")
    gs = eng.graph_stats
    print(f"compile_events: {len(eng.compile_events)}  cuda graphs: "
          f"{gs['captures']} captured ({gs['capture_s']:.3f}s capturing), "
          f"{gs['replays']} replays")
    if args.chunked_prefill or args.max_prefill_tokens == "auto":
        print(f"max_prefill_tokens: {eng.max_prefill_tokens}")
    if tel is not None:
        _report_telemetry(tel, daemon)
    if args.profile:
        # the same requests again under the profiler (which slows the
        # host several-fold): device time by kernel, idle share against
        # the unprofiled wall time above
        *_, dt_prof, prof = run(prompts[1:], profile=True)
        report(prof, dt, dt_prof)


def _export(args, tel) -> None:
    if args.metrics_dir:
        os.makedirs(args.metrics_dir, exist_ok=True)
        tel.export_prometheus(os.path.join(args.metrics_dir, "metrics.prom"))
        tel.write_snapshot(os.path.join(args.metrics_dir, "metrics.jsonl"),
                           arch=args.arch)
        grid = os.path.join(args.metrics_dir, "latency_grid.json")
        tel.export_latency_grid(grid)
        print(f"metrics -> {args.metrics_dir}/ (refit: python -m "
              f"repro_torch.launch.autotune --refit-from {grid})")
    if args.trace_out:
        tel.export_trace(args.trace_out)
        print(f"trace -> {args.trace_out} (open at https://ui.perfetto.dev)")


def _report_telemetry(tel, daemon) -> None:
    s = tel.summary()
    ms = lambda v: "n/a" if v is None else f"{v * 1e3:.3f} ms"  # noqa: E731
    print(f"telemetry: ttft p50 {ms(s['ttft_p50'])} p95 {ms(s['ttft_p95'])}"
          f", itl p50 {ms(s['itl_p50'])} p95 {ms(s['itl_p95'])}, step p50 "
          f"{ms(s['step_p50'])} p95 {ms(s['step_p95'])}, padding waste "
          f"{s['padding_waste']:.1%}")
    if tel.flight is not None:
        n = len(tel.flight.dumps)
        where = f" (last: {tel.flight.dumps[-1]}*)" if n else ""
        print(f"flight recorder: rolling p95 "
              f"{(tel.flight.rolling_p95() or 0) * 1e3:.3f} ms against the "
              f"SLO {tel.flight.slo_p95_s * 1e3:.3f} ms, {n} dump(s){where}")
    if daemon is not None:
        rep = daemon.report()
        print(f"online refit: {rep['refits']} refit(s), {rep['swaps']} "
              f"hot-swap(s) at steps {rep['swap_steps']}"
              + (f", tree: {rep['last_path']}" if rep["last_path"] else ""))


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
