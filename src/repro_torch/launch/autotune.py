"""Offline attention autotuner — the paper's Fig. 5 workflow as a CLI (the
port's counterpart of `examples/autotune_attn.py`, with its flags and
prints).

    python -m repro_torch.launch.autotune --out tuned/attn \
        [--q-heads 32 --kv-heads 8 --head-dim 128 --page-size 16] \
        [--max-seqs 8 --target-context 2048] [--hardware]
    python -m repro_torch.launch.autotune --out tuned/refit \
        --refit-from METRICS_DIR/latency_grid.json [--separate-host-overhead]

  1. **Sweep**: `microbench.scenario_grid` generates a realistic request
     mix (batch sizes x context lengths x decode shares); each scenario is
     split into its decode / prefill sub-batches and every KernelConfig in
     DECODE_SPACE / PREFILL_SPACE (and UNIFIED_SPACE on the whole
     scenario) is timed: the Hopper cost model without `--hardware`, the
     port's CUDA kernels on the card with it (20 warm-up launches, then
     the mean of 100 replayed in one CUDA graph; bf16).  `--hardware`
     without a card fails.
  2. **Fit + export**: `tune.tune_and_export` fits one regret-minimizing
     decision tree per phase and writes PREFIX.json (the trees,
     `heuristics.load`'s format, and the roofline's
     `suggested_max_prefill_tokens`) and PREFIX.py (the Listing-2-style
     rendering).
  3. **Serve**: `python -m repro_torch.launch.serve --heuristics
     PREFIX.json`, or $REPRO_ATTN_HEURISTICS=PREFIX.json.

`--refit-from` refits the trees from a serving run's latency grid
(`launch.serve --metrics-dir D` writes D/latency_grid.json) instead of
sweeping.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

from repro_torch.autotune.tune import tune_and_export


def main() -> None:
    ap = argparse.ArgumentParser(
        description="sweep kernel configs, fit decision trees, export "
                    "serving heuristics (paper Fig. 5)")
    ap.add_argument("--out", default="tuned/attn", metavar="PREFIX",
                    help="output prefix: writes PREFIX.json + PREFIX.py")
    ap.add_argument("--q-heads", type=int, default=32)
    ap.add_argument("--kv-heads", type=int, default=8)
    ap.add_argument("--head-dim", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-seqs", type=int, default=8,
                    help="decode batch width for the chunk-size roofline")
    ap.add_argument("--target-context", type=int, default=2048,
                    help="steady-state context for the chunk-size roofline")
    ap.add_argument("--hardware", action="store_true",
                    help="time the port's CUDA kernels on the card (H100) "
                         "instead of the Hopper cost model")
    ap.add_argument("--refit-from", default=None, metavar="GRID.json",
                    help="refit the trees from a serving-telemetry "
                         "latency grid (python -m repro_torch.launch.serve "
                         "--metrics-dir writes latency_grid.json) instead "
                         "of running the offline sweep")
    ap.add_argument("--min-count", type=int, default=1,
                    help="with --refit-from: drop grid entries observed "
                         "fewer than this many warm launches")
    ap.add_argument("--separate-host-overhead", action="store_true",
                    help="with --refit-from: subtract the estimated "
                         "per-launch host overhead (observed wall-clock "
                         "minus the roofline floor of the engine's "
                         "analytic flops / bytes_accessed) before "
                         "calibrating the cost model, so the tree ranks "
                         "configs by device time")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    path_json, path_py = args.out + ".json", args.out + ".py"

    if args.refit_from:
        from repro_torch.autotune.tune import refit_from_telemetry
        rep = refit_from_telemetry(
            args.refit_from, path_json, path_py, min_count=args.min_count,
            separate_host_overhead=args.separate_host_overhead)
        print(f"refit from {args.refit_from} -> {path_json} + {path_py}")
        for phase, st in rep["phases"].items():
            print(f"{phase}: {st['profiles']} observed profiles, "
                  f"{st['observed_points']} observed (profile, config) "
                  f"points, calibration x{st['calibration_ratio']:.3g}, "
                  f"tuned-vs-best-fixed "
                  f"{st['tuned_vs_untuned_speedup']:.3f}x")
            if st.get("host_overhead_s_est") is not None:
                applied = st.get("host_overhead_applied_s", 0.0)
                print(f"  device-side timing: host overhead "
                      f"~{st['host_overhead_s_est'] * 1e3:.3f} ms/launch "
                      f"(device fraction "
                      f"{st['device_time_fraction']:.1%}), "
                      + ("subtracted before calibration"
                         if applied else "diagnostic only "
                         "(--separate-host-overhead to apply)"))
        print(f"\nserve with it:\n  python -m repro_torch.launch.serve "
              f"--heuristics {path_json}")
        return
    t0 = time.perf_counter()
    rep = tune_and_export(
        path_json, path_py, use_hardware=args.hardware, seed=args.seed,
        max_seqs=args.max_seqs, target_context=args.target_context,
        num_q_heads=args.q_heads, num_kv_heads=args.kv_heads,
        head_dim=args.head_dim, page_size=args.page_size,
    )
    elapsed = time.perf_counter() - t0

    raw = json.load(open(path_json))
    where = "the Hopper cost model"
    if args.hardware:
        import torch
        where = torch.cuda.get_device_name(0)
    print(f"wrote {path_json} ({len(raw['decode_tree'])} decode leaves, "
          f"{len(raw['prefill_tree'])} prefill leaves) and {path_py}")
    print(f"sweep and fit: {elapsed:.1f}s on {where}")
    for phase, results in rep["results"].items():
        # the scenario whose configurations take the most time (on the
        # card each ran warm-up + 2 x iters launches)
        cost = [(sum(t for t in r.timings.values() if math.isfinite(t)), r)
                for r in results]
        total = sum(c for c, _ in cost)
        top, r = max(cost, key=lambda cr: cr[0])
        sc = r.scenario
        n_inf = sum(math.isinf(t) for r in results
                    for t in r.timings.values())
        print(f"{phase}: {len(results)} scenarios, {n_inf} inf; the "
              f"slowest: {sc.num_seqs} sequences, max context "
              f"{sc.max_context}, decode share {sc.decode_share:.2f}, "
              f"{top / total:.1%} of the phase's summed time")
    print(f"\ndecode tree (Listing 2 analog):\n{rep['listing']}")
    print(f"prefill tree:\n{rep['prefill']['listing']}")
    print(f"unified tree (token-packed step):\n"
          f"{rep['unified']['listing']}")
    print(f"decode: tuned-vs-best-fixed speedup "
          f"{rep['tuned_vs_untuned_speedup']:.3f}x, "
          f"max pointwise {rep['max_pointwise_speedup']:.2f}x, "
          f"oracle overhead {rep['tuned_vs_oracle_overhead']:.1%}")
    print(f"prefill: tuned-vs-best-fixed speedup "
          f"{rep['prefill']['tuned_vs_untuned_speedup']:.3f}x")
    print(f"unified: tuned-vs-best-fixed speedup "
          f"{rep['unified']['tuned_vs_untuned_speedup']:.3f}x "
          f"(one packed launch per mixed-batch grid row)")
    print(f"chunked-prefill budget (decode-latency roofline): "
          f"max_prefill_tokens={rep['suggested_max_prefill_tokens']}")
    print(f"\nserve with it:\n"
          f"  python -m repro_torch.launch.serve --heuristics {path_json}\n"
          f"  REPRO_ATTN_HEURISTICS={path_json} python -m "
          f"repro_torch.launch.serve ...")


if __name__ == "__main__":
    main()
