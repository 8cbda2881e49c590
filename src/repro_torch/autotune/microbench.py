"""Microbenchmark framework (paper §5.2, Fig. 5 left half), a port of
`repro.autotune.microbench`.

Runs OUTSIDE the serving runtime: generates realistic request mixes
(variable context/query lengths, decode shares — §7.1) and measures each
kernel configuration.  With `use_hardware=True` it times the port's CUDA
kernels on the card through `kernels/paged_attention/ops.py`, the calls
the engine makes; otherwise it evaluates the Hopper cost model
(costmodel.py), so the tuning WORKFLOW — sweep, compare, export
heuristics — is the same with or without a card.  `use_hardware=True`
without a card raises: it never falls back to the model.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np

from repro_torch.autotune.costmodel import (
    Scenario, decode_time, prefill_time, split_phases, unified_time,
)
from repro_torch.core.attention.heuristics import KernelConfig

# the Llama3-8B-flavored default geometry shared by scenario_grid and the
# chunk-size roofline in tune_and_export (one source of truth)
ARCH_DEFAULTS = {"num_q_heads": 32, "num_kv_heads": 8, "head_dim": 128,
                 "page_size": 16}
# the reference's sweep axes
BATCH_SIZES = (1, 4, 16, 64, 128)
MAX_LENS = (128, 1024, 8192, 32768)
DECODE_SHARES = (0.0, 0.5, 1.0)
# the reference's timing recipe (paper §7.1): warm-up launches, then the
# mean of this many
WARMUP, ITERS = 20, 100


def scenario_grid(*, num_q_heads=ARCH_DEFAULTS["num_q_heads"],
                  num_kv_heads=ARCH_DEFAULTS["num_kv_heads"],
                  head_dim=ARCH_DEFAULTS["head_dim"],
                  page_size=ARCH_DEFAULTS["page_size"],
                  seed=0, batch_sizes=BATCH_SIZES, max_lens=MAX_LENS,
                  decode_shares=DECODE_SHARES) -> list[Scenario]:
    """The paper's Llama3-8B-flavored sweep: batch sizes x max sequence
    lengths x decode shares, with per-request length jitter.  The axes
    default to the reference's; a cut grid (fewer points, the same
    recipe) takes others."""
    rng = np.random.default_rng(seed)
    out = []
    for bs, max_len, dshare in itertools.product(
        batch_sizes, max_lens, decode_shares
    ):
        ctx = rng.integers(max(max_len // 4, 16), max_len + 1, size=bs)
        n_dec = int(round(bs * dshare))
        qlens = np.ones(bs, np.int64)
        if bs - n_dec:
            qlens[n_dec:] = np.minimum(
                ctx[n_dec:], rng.integers(64, 2048, size=bs - n_dec)
            )
        out.append(Scenario(
            num_seqs=bs, context_lens=tuple(int(c) for c in ctx),
            query_lens=tuple(int(q) for q in qlens),
            num_q_heads=num_q_heads, num_kv_heads=num_kv_heads,
            head_dim=head_dim, page_size=page_size,
        ))
    return out


DECODE_SPACE: list[KernelConfig] = [
    KernelConfig("baseline"),
    *[KernelConfig("gqa", tile=t) for t in (8, 16)],
    *[KernelConfig("segmented", tile=t, num_segments=s)
      for t in (8, 16) for s in (2, 4, 8, 16)],
]

PREFILL_SPACE: list[KernelConfig] = [
    KernelConfig("gqa", tile=t, block_q=bq)
    for t in (8, 16) for bq in (8, 16, 32, 64)
]

# the unified launch tunes both regions at once: the decode-region variant
# (C1-C3) x the chunk-region Q-block size, over a shared tile
UNIFIED_SPACE: list[KernelConfig] = [
    *[KernelConfig("gqa", tile=t, block_q=bq)
      for t in (8, 16) for bq in (8, 16, 32)],
    *[KernelConfig("segmented", tile=16, num_segments=s, block_q=bq)
      for s in (4, 8) for bq in (16, 32)],
]


def measure(scenario: Scenario, cfg: KernelConfig, *,
            use_hardware: bool = False, unified: bool = False,
            warmup: int = WARMUP, iters: int = ITERS) -> float:
    """Latency (s) of this config on this scenario.

    Padded engine (`unified=False`): a mixed batch runs as two launches
    (one decode, one prefill), so the scenario is split by phase (q == 1
    vs q > 1) and each sub-batch is costed/timed against its own launch
    only — costing the whole scenario in both phases would double-count
    every sequence's context.

    Packed engine (`unified=True`): the mixed batch IS the launch — the
    whole scenario is costed as one token-packed launch
    (costmodel.unified_time), which is what the unified tree is fit on.

    On the card (`use_hardware=True`) a configuration that its kernel
    wrapper refuses before launch (`LaunchLimitError`: the documented
    limits of kernels/paged_attention/kernel.py, such as the fp32
    prefill's shared memory) times as `math.inf`, as the cost model
    prices an over-budget configuration; any other error raises."""
    if use_hardware:
        from repro_torch.kernels._common import LaunchLimitError

        timing = dict(warmup=warmup, iters=iters)
        try:
            if unified:
                return _measure_unified_on_device(scenario, cfg, **timing)
            dec, pre = split_phases(scenario)
            return sum(_measure_on_device(sub, cfg, **timing)
                       for sub in (dec, pre) if sub is not None)
        except LaunchLimitError:
            return math.inf
    tile = cfg.tile or scenario.page_size
    if unified:
        return unified_time(scenario, variant=cfg.variant, tile=tile,
                            num_segments=cfg.num_segments,
                            block_q=cfg.block_q)
    dec, pre = split_phases(scenario)
    t = 0.0
    if dec is not None:
        t += decode_time(dec, variant=cfg.variant, tile=tile,
                         num_segments=cfg.num_segments)
    if pre is not None:
        t += prefill_time(pre, block_q=cfg.block_q, tile=tile)
    return t


def _card():
    """torch and the card's device; raises when there is no card (the
    sweep never falls back to the cost model)."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("use_hardware=True needs a CUDA device "
                           "(torch.cuda.is_available() is False)")
    return torch, torch.device("cuda", torch.cuda.current_device())


def _device_inputs(torch, dev, s: Scenario, dtype):
    """Seeded K and V page pools (independent: aliasing V onto K would
    halve the traffic the sweep is supposed to measure), the page table
    (sequence i on pages 1 + i * np .. (i + 1) * np; page 0 unused) and
    the context lengths, on the card."""
    g = torch.Generator(device=dev).manual_seed(0)
    np_ = -(-s.max_context // s.page_size)
    p = s.num_seqs * np_ + 1
    shape = (s.num_kv_heads, p, s.page_size, s.head_dim)
    kp = torch.randn(shape, generator=g, device=dev, dtype=dtype)
    vp = torch.randn(shape, generator=g, device=dev, dtype=dtype)
    pt = torch.arange(1, 1 + s.num_seqs * np_, dtype=torch.int32,
                      device=dev).reshape(s.num_seqs, np_)
    ctx = torch.tensor(s.context_lens, dtype=torch.int32, device=dev)
    return g, kp, vp, pt, ctx


def _packed_q(torch, dev, g, s: Scenario, dtype):
    """q [sum(query_lens), Hq, D], query_start_loc [S+1], query_lens [S]."""
    q = torch.randn((sum(s.query_lens), s.num_q_heads, s.head_dim),
                    generator=g, device=dev, dtype=dtype)
    qsl = torch.tensor(np.concatenate([[0], np.cumsum(s.query_lens)]),
                       dtype=torch.int32, device=dev)
    qlens = torch.tensor(s.query_lens, dtype=torch.int32, device=dev)
    return q, qsl, qlens


def time_graphed(run, *, warmup: int = WARMUP, iters: int = ITERS) -> float:
    """Mean device seconds of `run()` (a launch on the card): `warmup`
    eager calls, then `iters` calls captured into one CUDA graph (the
    cyclic collector paused around the capture); after one untimed
    replay, one replay is timed between two CUDA events and divided by
    `iters`.  The wrappers' host enqueue (20-90 us a call eagerly) is not
    in it: inside the engine's graphs these kernels run the same way."""
    import torch

    from repro_torch.serving.cuda_graphs import counted, gc_paused

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(warmup):
            run()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()

    def capture():
        with gc_paused(), torch.cuda.graph(graph, stream=stream):
            for _ in range(iters):
                run()

    counted(capture)  # a capture runs nothing: launches are not counted
    graph.replay()  # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def _measure_on_device(scenario: Scenario, cfg: KernelConfig,
                       warmup: int = WARMUP, iters: int = ITERS) -> float:
    """Device time of the real kernels on the card (paper §7.1: 20 warm-up
    launches, the mean of 100; `time_graphed`).  Expects a single-phase
    scenario (see `measure`): all-decode batches time the decode kernel
    (`ops.paged_attention_decode`), batches with query_lens > 1 the
    Q-Block prefill (`ops.paged_attention_prefill`), in bf16
    (dtype_bytes 2) or fp32."""
    from repro_torch.kernels.paged_attention import ops

    torch, dev = _card()
    s = scenario
    dtype = torch.bfloat16 if s.dtype_bytes == 2 else torch.float32
    g, kp, vp, pt, ctx = _device_inputs(torch, dev, s, dtype)
    if any(q > 1 for q in s.query_lens):
        q, qsl, qlens = _packed_q(torch, dev, g, s, dtype)

        def run():
            return ops.paged_attention_prefill(
                q, kp, vp, pt, ctx, qsl, qlens, block_q=cfg.block_q,
                tile=cfg.tile)
    else:
        q = torch.randn((s.num_seqs, s.num_q_heads, s.head_dim),
                        generator=g, device=dev, dtype=dtype)

        def run():
            return ops.paged_attention_decode(
                q, kp, vp, pt, ctx, variant=cfg.variant, tile=cfg.tile,
                num_segments=cfg.num_segments)

    return time_graphed(run, warmup=warmup, iters=iters)


def _measure_unified_on_device(scenario: Scenario, cfg: KernelConfig,
                               warmup: int = WARMUP,
                               iters: int = ITERS) -> float:
    """Device time of the REAL packed launch
    (`ops.paged_attention_unified`) on a mixed scenario — the engine's
    packed layout: q == 1 sequences first (the decode region), chunks
    behind them.  This is what the unified tree must be fit to on the
    card; summing separate per-phase kernel timings would miss the packed
    launch's own behavior."""
    from repro_torch.kernels.paged_attention import ops

    torch, dev = _card()
    pairs = sorted(zip(scenario.context_lens, scenario.query_lens),
                   key=lambda cq: cq[1] > 1)  # decode rows first
    s = dataclasses.replace(
        scenario, context_lens=tuple(c for c, _ in pairs),
        query_lens=tuple(q for _, q in pairs))
    nd = sum(1 for q in s.query_lens if q == 1)
    dtype = torch.bfloat16 if s.dtype_bytes == 2 else torch.float32
    g, kp, vp, pt, ctx = _device_inputs(torch, dev, s, dtype)
    q, qsl, qlens = _packed_q(torch, dev, g, s, dtype)

    def run():
        return ops.paged_attention_unified(
            q, kp, vp, pt, ctx, qsl, qlens, num_decode_seqs=nd,
            variant=cfg.variant, tile=cfg.tile,
            num_segments=cfg.num_segments, block_q=cfg.block_q)

    return time_graphed(run, warmup=warmup, iters=iters)


@dataclasses.dataclass
class SweepResult:
    scenario: Scenario
    timings: dict[int, float]  # config index -> seconds

    def best(self, space) -> KernelConfig:
        idx = min(self.timings, key=self.timings.get)
        return space[idx]


def sweep(scenarios, space, *, use_hardware=False, unified=False,
          warmup: int = WARMUP, iters: int = ITERS) -> list[SweepResult]:
    out = []
    for sc in scenarios:
        timings = {
            i: measure(sc, cfg, use_hardware=use_hardware, unified=unified,
                       warmup=warmup, iters=iters)
            for i, cfg in enumerate(space)
        }
        out.append(SweepResult(sc, timings))
    return out
