"""Analytic timing model of the port's paged-attention kernels on one
NVIDIA H100, with the reference's interface (`repro.autotune.costmodel`):
`Scenario`, `split_phases`, `decode_time`, `prefill_time`, `unified_time`
and `suggest_max_prefill_tokens`.

On the card the microbenchmark (microbench.py) times the real kernels;
without one this model stands in: for the refit loop's unobserved
configurations, `--heuristics tune` and the chunk-size roofline.  It
models what the kernels of csrc/paged_attention.cu do on Hopper, the
paper's effects (§4.3-4.7) as they arise there:

  * decode is bounded by bytes (a key costs 4 M D FLOPs against 4 D bytes
    of bf16 K and V): one streaming block per (sequence, KV head, row
    group) reads its KV head's pages once.  C1 (baseline): the port's
    kernel makes the query heads of a KV head rows of one block, so C1
    reads each page once, as C2 does, and costs what C2 costs; the
    paper's per-query-head re-read (x group bytes) does not arise on it.
  * rows a block: the decode kernel takes its rows in blocks of RB in
    {1, 4, 8}; a group above 8 is more blocks over the same keys (their
    repeat read comes from L2 and is not charged).  The bf16 Q-Block
    prefill runs `mma.sync` m16n8k16 on 16-row warp slabs, so its
    block_q x group rows are padded to a multiple of 16 and the dead rows
    are computed; its key tile is its own 64.
  * grid blocks against the 132 SMs: one streaming block alone draws
    about BLOCK_STREAM_BW from memory, and one prefill block gets at most
    one SM's share of the tensor cores, so a launch of few blocks (small
    batch, long context) is bounded by its longest block, not by HBM or
    by the card's peak.  C3 cuts the longest block into segments over the
    page-table width, and pays for its fp32 partials (written, then read
    back by the merging block).
  * the per-block shared-memory footprint: the fp32 prefill keeps q, its
    accumulator and the scores in shared memory (`_attend_smem_bytes`,
    the arithmetic of `pa_attend_smem_bytes`); a configuration over the
    227 KB a block may opt in to is refused by the wrapper before launch
    and costs inf here.  The bf16 kernels' footprints are fixed.
  * a fixed cost a launch inside a CUDA graph (the engine replays its
    steps as graphs): LAUNCH_OVERHEAD_S for a decode launch,
    PREFILL_OVERHEAD_S for the prefill with its host layer's metadata and
    packing kernels (kernels/paged_attention/ops.py).
  * `tile` must divide the page (else inf: `heuristics.validate` would
    drop it); the decode kernels validate it only, but C3's segment
    bounds are whole tiles.

The constants are the card's: hw.py's data-sheet rates, and four figures
read off one H100 (beside each, with the run they come from).  No TPU
figure is used.
"""
from __future__ import annotations

import dataclasses

from repro_torch.roofline import hw
from repro_torch.utils.misc import cdiv

# The four figures read off the card, all by `chip_smoke.tune_calibrate`
# (phase 19) at smollm-135m's heads in bf16, each the mean of 100
# launches replayed in one CUDA graph, on an NVIDIA H100 80GB HBM3 at a
# 700.00 W power limit (the readings are in PERF.md §6):
#
# a decode launch at 1 sequence of 16 keys: 5.02 us.  It holds the
# ~0.30 us gap between graph nodes (0.696 ms over 2,335 nodes of the
# decode graph, PERF.md §5) and the kernel's least run.
LAUNCH_OVERHEAD_S = 5.02e-6
# ops.paged_attention_prefill at 1 sequence of 16 rows: 86.62 us, the
# kernel and the host layer's metadata and packing kernels.
PREFILL_OVERHEAD_S = 86.62e-6
# one streaming decode block alone: the decode at 1 sequence of 4096 keys
# (3 KV heads, a block each, 1 MiB of K and V a block) in 82.09 us, less
# LAUNCH_OVERHEAD_S: 13.6 GB/s.
BLOCK_STREAM_BW = 13.6e9
# the Q-Block prefill at 8 sequences of 1024 fresh rows in 260.78 us: the
# FLOPs `prefill_time` counts for it (1.046e10) over its time less
# PREFILL_OVERHEAD_S are 0.0607 of the bf16 peak.  The fp32 scalar
# prefill is not timed by the sweep; the same share of the fp32 peak
# stands in for it.
MMA_EFFICIENCY = 0.0607
MMA_ROWS = 16  # rows of an mma.sync m16n8k16 warp slab
PREFILL_KEY_TILE = 64  # keys the bf16 prefill stages at once
PREFILL_BLOCK_SLABS = 4  # warp slabs a prefill block takes
STAGED_KEYS = 16  # keys the fp32 prefill stages in shared memory at once


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One microbenchmark point (mirrors paper §7.1: variable-length
    batches, decode share).  `dtype_bytes` 2 is bf16 (the tensor-core
    prefill), 4 fp32 (the scalar one)."""
    num_seqs: int
    context_lens: tuple[int, ...]  # one per seq
    query_lens: tuple[int, ...]  # 1 = decode
    num_q_heads: int
    num_kv_heads: int
    head_dim: int
    page_size: int
    dtype_bytes: int = 2
    # speculative-decoding dimension mirrored from BatchProfile: pow2
    # count of draft tokens verified in the launch (0: non-speculative).
    # The token work already rides in query_lens (spec rows pack as
    # q=k+1 resumed chunks); this keeps the feature visible to fit_tree
    # so a refit can split spec from plain traffic.
    spec_tokens: int = 0

    @property
    def group(self) -> int:
        return self.num_q_heads // self.num_kv_heads

    @property
    def decode_share(self) -> float:
        d = sum(1 for q in self.query_lens if q == 1)
        return d / max(len(self.query_lens), 1)

    @property
    def max_context(self) -> int:
        return max(self.context_lens) if self.context_lens else 0

    @property
    def avg_query_len(self) -> float:
        return sum(self.query_lens) / max(len(self.query_lens), 1)

    @property
    def total_tokens(self) -> int:
        """Packed token-stream length: what the unified launch buckets on."""
        return sum(self.query_lens)


def split_phases(s: Scenario) -> tuple[Scenario | None, Scenario | None]:
    """(decode_sub, prefill_sub): the q==1 sequences and the q>1 sequences
    as standalone scenarios (None for an empty phase).  A mixed batch runs
    as TWO launches in the padded engine — one decode launch and one
    prefill launch — so each phase must be costed against its own
    sequences only; charging a prefill sequence's context to the decode
    launch (or vice versa) double-counts the work."""
    dec = [(c, q) for c, q in zip(s.context_lens, s.query_lens) if q == 1]
    pre = [(c, q) for c, q in zip(s.context_lens, s.query_lens) if q > 1]

    def sub(pairs):
        if not pairs:
            return None
        return dataclasses.replace(
            s, num_seqs=len(pairs),
            context_lens=tuple(c for c, _ in pairs),
            query_lens=tuple(q for _, q in pairs),
        )

    return sub(dec), sub(pre)


def _bad_tile(s: Scenario, tile: int) -> bool:
    return tile < 1 or tile > s.page_size or s.page_size % tile != 0


def _attend_smem_bytes(rows: int, head_dim: int, tile: int) -> int:
    """Shared memory of one fp32 prefill block (`attend_smem_floats` of
    csrc/paged_attention.cu): q and the accumulator [rows, D], the scores
    [rows, tile], m / l / alpha [rows], and the staged keys
    [STAGED_KEYS, D + 1], in floats."""
    return 4 * (2 * rows * head_dim + rows * tile + 3 * rows
                + STAGED_KEYS * (head_dim + 1))


def _stream_rows_per_block(rows: int) -> int:
    """RB of the streaming decode kernel (`rows_per_block`)."""
    return 1 if rows <= 1 else 4 if rows <= 4 else 8


def decode_time(s: Scenario, *, variant: str, tile: int,
                num_segments: int = 8) -> float:
    """Predicted latency of one decode attention launch (in a graph)."""
    if variant not in ("baseline", "gqa", "segmented"):
        raise ValueError(variant)
    if _bad_tile(s, tile):
        return float("inf")
    # a decode launch only covers the q==1 sequences: in a mixed batch the
    # q>1 sequences run through the separate prefill launch, so their
    # context must not be charged here
    dec_ctx = [c for c, q in zip(s.context_lens, s.query_lens) if q == 1]
    if not dec_ctx:
        return 0.0
    n_dec = len(dec_ctx)
    kv_row = 2 * s.head_dim * s.dtype_bytes  # K + V of one key, one head
    rows = s.group  # baseline too: a KV head's query heads are one block
    row_groups = cdiv(rows, _stream_rows_per_block(rows))
    width = cdiv(max(dec_ctx), s.page_size) * s.page_size  # page-table keys
    nseg, span = 1, width
    if variant == "segmented":
        num_tiles = width // tile
        nseg = min(num_segments, num_tiles)
        span = cdiv(num_tiles, nseg) * tile
    bytes_ = sum(dec_ctx) * kv_row * s.num_kv_heads \
        + 2 * n_dec * s.num_q_heads * s.head_dim * s.dtype_bytes
    if variant == "segmented":  # fp32 partials (o, m, l) out and back
        bytes_ += 2 * (n_dec * s.num_kv_heads * row_groups * nseg
                       * _stream_rows_per_block(rows) * (s.head_dim + 2) * 4)
    longest = min(max(dec_ctx), span) * kv_row  # one block's live keys
    return max(bytes_ / hw.HBM_BW, longest / BLOCK_STREAM_BW) \
        + LAUNCH_OVERHEAD_S


def prefill_time(s: Scenario, *, block_q: int, tile: int) -> float:
    """Predicted latency of one Q-Block prefill launch (C2, in a graph).

    bf16 (`prefill_mma_kernel`): each Q-block's block_q x group rows are
    padded to whole 16-row warp slabs (the ragged last Q-block of a
    sequence to block_q tokens too), and a block of 4 slabs reads the
    64-key tiles up to its own last row: the causal waste is a block's
    64 rows, whatever block_q is.  fp32 (`prefill_kernel`): one block a
    Q-block, `tile` keys at once, up to the Q-block's last row."""
    if _bad_tile(s, tile):
        return float("inf")
    rows = block_q * s.group
    bf16 = s.dtype_bytes == 2
    if not bf16 and _attend_smem_bytes(rows, s.head_dim, tile) \
            > hw.SMEM_PER_BLOCK:
        return float("inf")  # the wrapper refuses it before launch
    kv_row = 2 * s.head_dim * s.dtype_bytes
    if bf16:
        slabs = cdiv(rows, MMA_ROWS)
        key_tile, rate = PREFILL_KEY_TILE, hw.PEAK_FLOPS_BF16
        block_rows = PREFILL_BLOCK_SLABS * MMA_ROWS
        # a block's last row lies half a block of tokens past its mean
        causal = block_rows / s.group / 2
    else:
        key_tile, rate = tile, hw.PEAK_FLOPS_FP32
        block_rows = rows
        causal = block_q / 2
    rate *= MMA_EFFICIENCY
    flops = bytes_ = 0.0
    tokens = units = longest = 0
    # only the q>1 sequences run through the prefill launch; decode
    # (q==1) sequences are costed by decode_time for their own launch
    for ctx, q in zip(s.context_lens, s.query_lens):
        if q <= 1:
            continue
        tokens += q
        nqb = cdiv(q, block_q)
        # rows computed (dead ones too) x the keys a row's block reads on
        # average: the row's own position, the causal waste, and half a
        # key tile of rounding
        run = nqb * slabs * MMA_ROWS if bf16 else nqb * rows
        keys = min(ctx - q / 2 + causal, ctx) + (key_tile - 1) / 2
        flops += 4.0 * run * keys * s.head_dim * s.num_kv_heads
        units += nqb * slabs if bf16 else nqb
        longest = max(longest, cdiv(ctx, key_tile) * key_tile)
        bytes_ += ctx * kv_row * s.num_kv_heads
    if not tokens:
        return 0.0
    # q in, packed, scattered back and out (ops.paged_attention_prefill)
    bytes_ += 6 * tokens * s.num_q_heads * s.head_dim * s.dtype_bytes
    blocks = cdiv(units, PREFILL_BLOCK_SLABS if bf16 else 1) \
        * s.num_kv_heads
    sm_rate = rate / hw.NUM_SMS  # one block holds at most one SM
    t = max(flops / rate, 4.0 * block_rows * longest * s.head_dim / sm_rate,
            bytes_ / hw.HBM_BW)
    if blocks < hw.NUM_SMS:  # an under-filled card: the blocks' own rate
        t = max(t, flops / (blocks * sm_rate))
    return t + PREFILL_OVERHEAD_S


def unified_time(s: Scenario, *, variant: str, tile: int,
                 num_segments: int = 8, block_q: int = 16) -> float:
    """Predicted latency of ONE token-packed unified launch over a mixed
    batch: the q == 1 rows stream through the decode kernel (variant
    C1-C3) and the q > 1 chunks through the Q-Block prefill.  In the
    port's graph the two regions are their own kernels, one after the
    other (ops.paged_attention_unified), so the launch costs their sum:
    packing saves the padded step's second host dispatch (a graph replay
    or eager launch, outside these kernels), not kernel time."""
    dec, pre = split_phases(s)
    t = 0.0
    if dec is not None:
        t += decode_time(dec, variant=variant, tile=tile,
                         num_segments=num_segments)
    if pre is not None:
        t += prefill_time(pre, block_q=block_q, tile=tile)
    return t


def suggest_max_prefill_tokens(
    *,
    num_q_heads: int,
    num_kv_heads: int,
    head_dim: int,
    page_size: int,
    max_seqs: int = 8,
    target_context: int = 2048,
    itl_slack: float = 4.0,
    block_q: int = 16,
    candidates: tuple[int, ...] = (16384, 8192, 4096, 2048, 1024, 512,
                                   256, 128, 64, 32),
) -> int:
    """Chunk-size autotuner (the reference's algorithm): pick the
    scheduler's per-step prefill token budget from the decode-latency
    roofline instead of a constant.

    Chunked prefill exists to keep inter-token latency flat: each step runs
    one decode launch plus (at most) one budget-sized prefill chunk, so the
    ITL stretch a chunk adds is prefill_time(chunk) / decode_time(batch).
    This picks the LARGEST budget whose predicted chunk latency stays
    within `itl_slack` decode-launch-equivalents for a `max_seqs`-wide
    batch at `target_context`.  The tile is the page: the bf16 kernels
    have no shared-memory limit to shrink it for (the reference's VMEM
    tile loop has no counterpart)."""
    dec = Scenario(
        num_seqs=max_seqs, context_lens=(target_context,) * max_seqs,
        query_lens=(1,) * max_seqs, num_q_heads=num_q_heads,
        num_kv_heads=num_kv_heads, head_dim=head_dim, page_size=page_size,
    )
    t_dec = decode_time(dec, variant="gqa", tile=page_size)
    floor = max(page_size, min(candidates))
    for c in sorted(candidates, reverse=True):
        chunk = Scenario(
            num_seqs=1, context_lens=(target_context + c,),
            query_lens=(c,), num_q_heads=num_q_heads,
            num_kv_heads=num_kv_heads, head_dim=head_dim,
            page_size=page_size,
        )
        if prefill_time(chunk, block_q=block_q, tile=page_size) \
                <= itl_slack * t_dec:
            return max(c, floor)
    return floor
