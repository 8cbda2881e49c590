"""The grouped expert GEMM pair on the card, for one source tree or two in
turn.  Run on an H100:

    python tools/moe_gemm_probe.py [--src DIR] [--compare DIR2]
        [--rounds 2] [--out build/moe_probe.json]

A source tree is a checkout's root.  Each measurement runs in a process
of its own that imports the port from the tree's `src/` (building the
grouped GEMM's library there) and times it with this checkout's
`chip_smoke.moe_time_row`: `expert_ffn` (the gate / up launch with the
fused SwiGLU, then the down launch) in bf16 between CUDA events, L2
flushed before each call, at

- deepseek-v2-236b's padded prefill: E 160, d 5120, ff 1536, 8 x 1024
  tokens x top-6 = 49,152 rows, routings `uniform` and `one_expert`
  (`chip_smoke.moe_routing`);
- llama4-maverick's widths (E 128, d 5120, ff 8192) at 8 and 520 rows,
  uniform (`chip_smoke.py` phase 21 (a));
- deepseek-v2's 40 experts a rank, the `tail` launch of rank 0 of 4 at
  48 and 3,120 rows (phase 26 (a)), the enqueue hidden behind a spin.

Beside each: the plain version, two library yardsticks the port never
calls (a loop of `torch.matmul` over the touched experts, their group
sizes read on the host beforehand; and `torch._grouped_mm`, where the
card's PyTorch has it, with the offsets on the device), the bound, the
kernel's largest error against the plain version in bf16 ulps of the
element's own magnitude, and launches by CUDA kernel.  With `--compare`,
the trees run A B B A (`--rounds` times that); every measurement is one
JSON line in `--out` and its log is printed, then a table.  The card's
name and power limit come first.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PREFILL = dict(e=160, d=5120, ff=1536, rows=49152)
MAVERICK = dict(e=128, d=5120, ff=8192)


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _row(torch, CS, GK, GO, case, ws, xs, off, flush, iters, tail=False,
         lead=0, live=None):
    """`chip_smoke.moe_time_row`'s numbers, the kernel's largest error
    against the plain version in bf16 ulps of each element's magnitude,
    and the launches by CUDA kernel."""
    GK.reset_launches()
    got = GO.expert_ffn(xs, off, *ws, tail=tail)
    torch.cuda.synchronize()
    launches = dict(GK.KERNEL_LAUNCHES)
    want = GK.grouped_gemm_plain(GK.grouped_gemm_plain(
        xs, ws[0], off, ws[1], tail=tail), ws[2], off, tail=tail)
    ulps = float(((got.float() - want.float()).abs()
                  / CS.bf16_ulps(torch, want)).max())
    del got, want
    e, d, ff = ws[0].shape
    row, gmm_ms = CS.moe_time_row(torch, GK, GO, ws, xs, off, case, flush,
                                  iters, tail=tail, lead=lead, live=live)
    return dict(row, case=case, e=e, d=d, ff=ff, rows=xs.shape[0],
                live=xs.shape[0] if live is None else live,
                touched=int((off[1:] > off[:-1]).sum()),
                grouped_mm_ms=gmm_ms, of_bound=row["bound_ms"] / row["ms"],
                max_err_ulps=ulps, launches=launches)


def measure(src: str, cases: list[str]) -> list[dict]:
    """One process's rows for the port under the tree `src`, timed by this
    checkout's `chip_smoke.py`."""
    sys.path[:0] = [str(Path(src) / "src"), str(ROOT)]
    import torch

    import chip_smoke as CS
    from repro_torch.kernels.moe import kernel as GK
    from repro_torch.kernels.moe import ops as GO

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    GK.library()
    build_s = time.perf_counter() - t0
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(CS.SEED + 32)
    gh = torch.Generator(device="cpu").manual_seed(CS.SEED + 32)
    bf16 = torch.bfloat16
    rows = []
    for name, shape, routed in (
            ("prefill", PREFILL, [(PREFILL["rows"], "uniform"),
                                  (PREFILL["rows"], "one_expert")]),
            ("maverick", MAVERICK, [(8, "uniform"), (520, "uniform")])):
        if name not in cases:
            continue
        e, d = shape["e"], shape["d"]
        ws = CS.moe_weights(torch, e, d, shape["ff"], bf16, g)
        for n, routing in routed:
            off = CS.moe_offsets(torch, CS.moe_routing(torch, routing, n, e,
                                                       gh), e)
            xs = torch.randn((n, d), generator=g, device="cuda").to(bf16)
            rows.append(_row(torch, CS, GK, GO, f"{name} {n} {routing}", ws,
                             xs, off, flush, 10 if n > 1000 else 20))
            del xs
        del ws
        torch.cuda.empty_cache()
    if "tail" in cases:
        cfg = CS.ep_cfg(False)
        e_loc = cfg.moe.num_experts // CS.EP_RANKS
        ws = CS.ep_experts(torch, range(e_loc), cfg.d_model,
                           cfg.moe.d_ff_expert, bf16)
        for n in CS.EP_ROWS:
            xs, off, _, live, _ = CS.ep_rank_launch(torch, cfg, 0,
                                                    CS.EP_RANKS, n)
            rows.append(_row(torch, CS, GK, GO, f"tail {xs.shape[0]}", ws,
                             xs, off, flush, 20, tail=True,
                             lead=CS.TP_LEAD_CYCLES, live=live))
        del ws
    for r in rows:
        r.update(src=src, build_s=build_s)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT))
    ap.add_argument("--compare", default=None)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--cases", default="prefill,maverick,tail")
    ap.add_argument("--out", default=str(ROOT / "build" / "moe_probe.json"))
    ap.add_argument("--measure", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    cases = args.cases.split(",")
    if args.measure:
        for row in measure(args.measure, cases):
            print("ROW " + json.dumps(row), flush=True)
        return
    print(f"nvidia-smi {_smi()}", flush=True)
    trees = [args.src] if args.compare is None else \
        [args.src, args.compare, args.compare, args.src]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    rows = []
    with out.open("w") as f:
        for _ in range(args.rounds):
            for tree in trees:
                proc = subprocess.run(
                    [sys.executable, __file__, "--measure",
                     str(Path(tree).resolve()), "--cases", args.cases],
                    capture_output=True, text=True, timeout=1800)
                if proc.returncode != 0:
                    print(proc.stdout[-4000:], proc.stderr[-8000:])
                    raise SystemExit(f"measure {tree} failed")
                for line in proc.stdout.splitlines():
                    if not line.startswith("ROW "):
                        print(f"{Path(tree).resolve().name}: {line}",
                              flush=True)
                        continue
                    row = json.loads(line[4:])
                    rows.append(row)
                    f.write(json.dumps(row) + "\n")
                    f.flush()
    for r in rows:
        gmm = ("null" if r["grouped_mm_ms"] is None
               else f"{r['grouped_mm_ms']:.4f}")
        print(f"{Path(r['src']).name:10s} {r['case']:24s} touched "
              f"{r['touched']:4d} kernel_ms {r['ms']:.4f} plain_ms "
              f"{r['plain_ms']:.4f} matmul_loop_ms {r['library_ms']:.4f} "
              f"grouped_mm_ms {gmm} bound_ms {r['bound_ms']:.4f} "
              f"({r['bound_by']}) of_bound {r['of_bound']:.3f} max_err_ulps "
              f"{r['max_err_ulps']:.2f} launches {r['launches']}")


if __name__ == "__main__":
    main()
