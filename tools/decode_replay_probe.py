"""Where the packed step's decode graph spends its time, for one source
tree or two in turn.  Run on an H100:

    PYTHONPATH=src python tools/decode_replay_probe.py [--src DIR]
        [--compare DIR2] [--rounds 1] [--archs smollm-135m,...]

Each tree runs in a process of its own that imports the port from `--src`
(default: this checkout's `src`) and `chip_smoke.py`'s helpers from this
checkout.  For each arch (bf16, random weights from `chip_smoke.SEED`,
drawn on the card) it serves `chip_smoke.py` phase 5's eight requests
(128-1024 tokens, 32 new, max_seqs 8, chunked at 512, request 3 sampled)
through the graphed packed step: smollm-135m through `submit()` +
`run()` as phase 5 (a) does, the others step by step as phase 25 (a)
does.  It then replays the decode-only graph of the finished run
(`chip_smoke.replay_cost`, top 15 kernels by device time) and logs its
replay against its byte bound (`chip_smoke.decode_graph_bound`).

With `--compare`, the trees run A B B A (`--rounds` times), one process
a tree, and one line a run follows.  The card's name and power limit
come first.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("smollm-135m", "musicgen-large", "qwen2-vl-2b")


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def measure(src: str, archs) -> dict:
    """One process's decode-graph replays for the port under `src`."""
    sys.path.insert(0, src)
    sys.path.insert(1, str(ROOT))
    import gc

    import torch

    import chip_smoke as CS
    from repro_torch import weights
    from repro_torch.configs import ARCHS as REG
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    K.library()
    out = {}
    for arch in archs:
        cfg = REG[arch]
        model = weights.init_random(cfg, CS.SEED, device="cuda",
                                    on_device=True)
        eng_kw = dict(max_seqs=8, num_pages=CS.FAMILY_PAGES,
                      max_model_len=2048, enable_chunked_prefill=True,
                      max_prefill_tokens=512, seed=CS.SEED,
                      debug_logits=True, device="cuda")
        served = CS.serve_prompts(torch, cfg.vocab_size)[2]
        reqs = [Request(prompt=list(p), max_new_tokens=32,
                        **(CS.SERVE_SAMPLED if i == 3 else {}))
                for i, p in enumerate(served)]
        run = (CS.stream_run if arch == CS.ARCH else CS.serve_run)(
            torch, Engine(cfg, model, **eng_kw), reqs, f"probe {arch}")
        CS.log(f"probe {src} {arch}")
        cost = CS.replay_cost(torch, run["eng"], top=15)
        bound_ms = CS.decode_graph_bound(run["eng"])[0]
        out[arch] = dict(replay_ms=cost["decode_replay_ms"],
                         kernels_ms=cost["decode_kernels_ms"],
                         kernels=cost["decode_kernels"], bound_ms=bound_ms)
        del run, model
        gc.collect()
        torch.cuda.empty_cache()
    return dict(src=src, archs=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--compare", default=None)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--archs", default=",".join(ARCHS))
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    archs = args.archs.split(",")
    if args.one:
        print("JSON" + json.dumps(measure(args.src, archs)), flush=True)
        return 0
    print(f"nvidia-smi {_smi('name,power.limit')}", flush=True)
    trees = [args.src] + ([args.compare] if args.compare else [])
    order = trees + trees[::-1] if args.compare else trees
    for r in range(args.rounds):
        for src in order:
            proc = subprocess.run(
                [sys.executable, __file__, "--one", "--src",
                 os.path.abspath(src), "--archs", args.archs],
                capture_output=True, text=True, timeout=1200)
            print("\n".join(ln for ln in proc.stdout.splitlines()
                            if not ln.startswith("JSON")), flush=True)
            if proc.returncode:
                print(proc.stderr[-6000:], file=sys.stderr)
                return 1
            row = json.loads([ln for ln in proc.stdout.splitlines()
                              if ln.startswith("JSON")][0][4:])
            for arch, v in row["archs"].items():
                print(f"round {r} {row['src']} {arch}: decode replay "
                      f"{v['replay_ms']:.4f} ms, {v['kernels']:.0f} kernels "
                      f"summing {v['kernels_ms']:.4f} ms, byte bound "
                      f"{v['bound_ms']:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
