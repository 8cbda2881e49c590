"""Where the bf16 latent decode's time goes on the card.  Run on an H100:

    PYTHONPATH=src python tools/mla_decode_probe.py

The served kernel carries no instrumentation.  This script writes a copy
of `src/repro_torch/csrc/mla_decode.cu` into `build/probe/` with clock64
stamps between the phases of a consumer warpgroup's tile (each
consumer's thread 0 sums its cycles a phase with atomicAdd into a
`__device__` array, read back by `mla_probe_read`), builds it with the
package's nvcc flags, and at deepseek-v2's widths (H 128, r 512, rope 64,
page 16, bf16) prints

- for 64 sequences of 4096 keys under five page layouts (a shuffled
  table; a contiguous one; every key on one page, so every load hits L2;
  H 64, one block a sequence, no tile shared; H 64 over 128 sequences,
  twice the bytes, none shared): the probe build's time with the enqueue
  hidden and each consumer warpgroup's cycles a tile by phase;
- for the 8-row serving step (contexts 0-2048, split as served): the
  served build's kernel and merge device time under `torch.profiler`.

The stamps cost a few cycles a phase; `chip_smoke.py` phase 22 times the
served build.  The card's name and power limit come first.  The stamps
go in at source lines named in `MARKS`: an edit to one of those lines
makes `instrument` raise until the mark is moved with it
(`tests/test_torch_mla.py` checks every mark still lands).
"""
from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

SRC = Path(__file__).resolve().parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.mla_decode import kernel as K  # noqa: E402
from repro_torch.kernels.mla_decode import ops  # noqa: E402

PHASES = ("wait tile", "S", "softmax", "wait P free", "P hand-off",
          "rescale + P.V", "release")
H, R, ROPE, PS = 128, 512, 64, 16
SCALE = (128 + ROPE) ** -0.5
ROWS8 = [0, 1, 17, 300, 777, 1024, 1500, 2048]

# (a line of the consumers' loop, stripped; a stamp before it; a stamp
# after it; how many times the line occurs).  PROBE(k) closes phase k.
MARKS = (
    ("const uint64_t dp = hopper::desc_sw128(p_s, 16, 1024);", None,
     "PROBE_INIT", 1),
    ("hopper::mbar_wait(&full[st], (t / Tile::kStages) & 1);", None,
     "PROBE(0)", 1),
    ("hopper::fence_regs(sc);", None, "PROBE(1)", 1),
    ("if (t > 0) hopper::mbar_wait(p_free, (t - 1) & 1);", "PROBE(2)",
     "PROBE(3)", 1),
    ("hopper::mbar_wait(p_full, t & 1);", None, "PROBE(4)", 2),
    ("if (half == 1) hopper::mbar_arrive(p_free);", "PROBE(5)", None, 1),
    ("hopper::mbar_arrive(&empty[st]);", None, "PROBE(6)", 1),
    ("hopper::named_sync(1, 2 * kWg);", "PROBE_FLUSH(half, n_tiles)", None,
     1),
)

MACROS = """
// probe: [half * 8 + k] the cycles of phase k, [16 + half] the blocks,
// [18 + half] the tiles
__device__ unsigned long long g_probe[32];
#define PROBE_INIT unsigned long long probe_[8] = {}, probe_t_ = clock64();
#define PROBE(k)                                   \\
  {                                                \\
    const unsigned long long probe_n_ = clock64(); \\
    probe_[k] += probe_n_ - probe_t_;              \\
    probe_t_ = probe_n_;                           \\
  }
#define PROBE_FLUSH(half, tiles)                                   \\
  if (tid == 0) {                                                  \\
    for (int k_ = 0; k_ < 8; ++k_)                                 \\
      atomicAdd(&g_probe[(half) * 8 + k_], probe_[k_]);            \\
    atomicAdd(&g_probe[16 + (half)], 1ull);                        \\
    atomicAdd(&g_probe[18 + (half)], (unsigned long long)(tiles)); \\
  }
"""

READ = """
// the probe's sums since the last read (then zeroed)
extern "C" int mla_probe_read(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
  if (err != cudaSuccess) return err;
  const unsigned long long zero[32] = {};
  return cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));
}
"""


def instrument(source: str) -> str:
    """The kernel source with the probe's stamps, macros and reader."""
    include = '#include "wgmma_tma.cuh"\n'
    if source.count(include) != 1:
        raise ValueError("probe: the source's wgmma_tma.cuh include moved")
    seen = {mark[0]: 0 for mark in MARKS}
    out = []
    for line in source.splitlines():
        mark = next((m for m in MARKS if line.strip() == m[0]), None)
        if mark is None:
            out.append(line)
            continue
        indent = line[:len(line) - len(line.lstrip())]
        seen[mark[0]] += 1
        out += ([indent + mark[1]] if mark[1] else []) + [line] \
            + ([indent + mark[2]] if mark[2] else [])
    missing = [m[0] for m in MARKS if seen[m[0]] != m[3]]
    if missing:
        raise ValueError(f"probe: these kernel lines are not where the "
                         f"marks expect them (move the marks): {missing}")
    text = "\n".join(out) + "\n"
    return text.replace(include, include + MACROS) + READ


def build() -> ctypes.CDLL:
    """Build the instrumented copy into build/probe/ and load it."""
    d = _build.BUILD_DIR / "probe"
    d.mkdir(parents=True, exist_ok=True)
    src = d / "mla_decode_probe.cu"
    src.write_text(instrument((_build.CSRC / "mla_decode.cu").read_text()))
    lib = d / "libmla_decode_probe.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(lib), str(src)], check=True)
    out = ctypes.CDLL(str(lib))
    out.mla_decode.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    out.mla_decode.restype = ctypes.c_int
    out.mla_probe_read.argtypes = [ctypes.c_void_p]
    out.mla_probe_read.restype = ctypes.c_int
    return out


def _inputs(g: torch.Generator, s: int, ctx: int, h: int = H):
    np_ = -(-ctx // PS)
    pool = s * np_ + 1
    q = torch.randn((s, h, R + ROPE), generator=g, device="cuda")
    kp = torch.randn((pool, PS, R + ROPE), generator=g, device="cuda")
    pt = (torch.randperm(pool - 1, generator=g, device="cuda")[:s * np_]
          .reshape(s, np_) + 1).to(torch.int32)
    cl = torch.full((s,), ctx, dtype=torch.int32, device="cuda")
    return q.to(torch.bfloat16), kp.to(torch.bfloat16), pt, cl


def _time_ms(fn, flush: torch.Tensor, iters: int = 10) -> float:
    """Median ms between CUDA events, L2 flushed and the enqueue hidden
    behind a ~1 ms spin before each call."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def layouts(g: torch.Generator) -> dict[str, tuple]:
    """The five 64 x 4096 cases: name -> (q, k_pages, page_table, ctx)."""
    q, kp, pt, cl = _inputs(g, 64, 4096)
    contiguous = (torch.arange(pt.numel(), dtype=torch.int32, device="cuda")
                  .reshape(pt.shape) + 1)
    q_lo, q_hi = q[:, :64].contiguous(), q[:, 64:].contiguous()
    kp2 = torch.cat([kp, torch.randn(kp.shape, generator=g, device="cuda")
                     .to(torch.bfloat16)])
    return {
        "shuffled": (q, kp, pt, cl),
        "contiguous": (q, kp, contiguous, cl),
        "one page (L2)": (q, kp, torch.ones_like(pt), cl),
        "H 64": (q_lo, kp, pt, cl),
        "H 64 x 128 seqs": (torch.cat([q_lo, q_hi]), kp2,
                            torch.cat([pt, pt + kp.shape[0]]),
                            torch.cat([cl, cl])),
    }


def probe_phases(lib: ctypes.CDLL, cases: dict[str, tuple],
                 flush: torch.Tensor) -> None:
    sums = (ctypes.c_ulonglong * 32)()
    for name, (q, kp, pt, cl) in cases.items():
        s, h = q.shape[:2]
        keys = pt.shape[1] * PS
        out = torch.empty((s, h, R), dtype=q.dtype, device=q.device)

        def call():  # one segment: no partials, no merge
            rc = lib.mla_decode(
                q.data_ptr(), kp.data_ptr(), pt.data_ptr(), cl.data_ptr(),
                out.data_ptr(), None, None, s, h, R + ROPE, R, pt.shape[1],
                PS, 1, keys, SCALE, 1, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"probe build's mla_decode: error {rc}")
        ms = _time_ms(call, flush)
        diff = (out.float() - K.mla_decode(q, kp, pt, cl, v_dim=R,
                                           scale=SCALE).float()).abs().max()
        lib.mla_probe_read(ctypes.addressof(sums))
        flush.zero_()
        call()
        torch.cuda.synchronize()
        if lib.mla_probe_read(ctypes.addressof(sums)):
            raise RuntimeError("mla_probe_read failed")
        v = list(sums)
        rate = s * keys * (R + ROPE) * 2 / ms / 1e9
        print(f"{name:16s} S {s} H {h}: {ms:.4f} ms (probe build, enqueue "
              f"hidden), {rate:.2f} TB/s of cached rows; output against the "
              f"served build's: max abs diff {float(diff):.3g}")
        for half in (0, 1):
            tiles = v[18 + half]
            cyc = [v[half * 8 + k] / tiles for k in range(len(PHASES))]
            print(f"  consumer {half}: cycles a tile " + ", ".join(
                f"{p} {c:.0f}" for p, c in zip(PHASES, cyc) if c)
                + f"; sum {sum(cyc):.0f} ({v[16 + half]} blocks)")


def profile_rows8(g: torch.Generator, flush: torch.Tensor,
                  iters: int = 10) -> None:
    q, kp, pt, _ = _inputs(g, len(ROWS8), max(ROWS8))
    cl = torch.tensor(ROWS8, dtype=torch.int32, device="cuda")
    nseg, seg = ops.split(len(ROWS8), H, pt.shape[1] * PS,
                          ops._sm_count(q.device))

    def call():
        return K.mla_decode(q, kp, pt, cl, v_dim=R, scale=SCALE,
                            num_segments=nseg, seg_keys=seg)
    call()
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            call()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA \
                and "mla_" in ev.key:
            us = getattr(ev, "self_device_time_total", None) \
                or ev.self_cuda_time_total
            name = re.search(r"mla_\w+", ev.key).group(0)
            print(f"8 rows, {nseg} segments of {seg} keys: {name} "
                  f"{us / ev.count:.1f} us a call (x{ev.count})")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe: needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    lib = build()
    g = torch.Generator(device="cuda").manual_seed(25)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    probe_phases(lib, layouts(g), flush)
    profile_rows8(g, flush)


if __name__ == "__main__":
    main()
