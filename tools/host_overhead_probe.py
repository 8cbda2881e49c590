"""The host's cost per operation on the card, for one source tree or two
in turn.  Run on an H100:

    PYTHONPATH=src python tools/host_overhead_probe.py [--src DIR]
        [--compare DIR2] [--rounds 3]

Each measurement runs in a process of its own that imports the port from
`--src` (default: this checkout's `src`): the paged attention kernels'
library is built there, and at `chip_smoke.py` phase 4's smollm-135m
decode shapes (bf16, page 16) it times

- a loop of small CUDA operations (`torch.where` and a multiply on 8
  elements), wall over the loop after a sync: the dispatcher's and the
  launch path's cost an operation;
- `paged_decode` (the wrapper: route, checks, launch), its host enqueue
  alone (`chip_smoke.host_us`) and between CUDA events with L2 flushed
  (`chip_smoke.time_ms`);
- `paged_decode_plain` on the same tensors (hundreds of small
  operations) between CUDA events.

With `--compare`, the two trees alternate, A B A B ..., `--rounds` times
each, one process a measurement, and a table of every run follows.  The
card's name, power limit and SM clock come first.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LOOP = 20000


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def measure(src: str) -> dict:
    """One process's numbers for the port under `src`."""
    sys.path.insert(0, src)
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as CS
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention import ops as tops

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    K.library()
    build_s = time.perf_counter() - t0
    x = torch.ones(8, device="cuda")
    y = torch.zeros(8, device="cuda")

    def loop():
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(LOOP):
            torch.where(x > 0, x, y) * 2.0
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / LOOP * 1e6

    loop()
    op_us = min(loop() for _ in range(3))
    calls, _ = CS.kernel_calls(torch, K, torch.bfloat16, 16,
                               tops.default_tile(16), tops)
    kfn, pfn = calls["paged_decode"]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    return dict(src=src, build_s=build_s, op_us=op_us,
                wrapper_host_us=CS.host_us(torch, kfn, iters=200),
                kernel_ms=CS.time_ms(torch, kfn, 50, flush),
                plain_ms=CS.time_ms(torch, pfn, 5, flush),
                sm_clock=_smi("clocks.sm"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--compare", default=None)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print("JSON" + json.dumps(measure(args.src)), flush=True)
        return 0
    print(f"nvidia-smi {_smi('name,power.limit')}, sm clock "
          f"{_smi('clocks.sm')}", flush=True)
    trees = [args.src] + ([args.compare] if args.compare else [])
    rows = []
    for r in range(args.rounds):
        for src in trees:
            out = subprocess.run(
                [sys.executable, __file__, "--one", "--src",
                 os.path.abspath(src)], capture_output=True, text=True,
                timeout=600)
            if out.returncode:
                print(out.stderr[-3000:], file=sys.stderr)
                return 1
            row = json.loads([ln for ln in out.stdout.splitlines()
                              if ln.startswith("JSON")][0][4:])
            rows.append(row)
            print(f"round {r} {row['src']}: op {row['op_us']:.2f} us, "
                  f"paged_decode host {row['wrapper_host_us']:.1f} us, "
                  f"kernel {row['kernel_ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.2f} ms, sm clock {row['sm_clock']} "
                  f"(build {row['build_s']:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
