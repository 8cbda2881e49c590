#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (`src/repro_torch`).

    python3 chip_smoke.py

Needs one NVIDIA GPU (written for an H100) and `nvcc`.  It imports nothing
of JAX and nothing of the JAX package.  Phases, each failing the run
(non-zero exit, no result line) on any error:

  1. device   the card's name and `nvidia-smi` name / power limit
  2. build    compile every csrc/*.cu with nvcc (sm_90a), one nvcc per
              source, all started together
  3. check    each of the four paged-attention kernels, and the segmented
              decode with the merge folded into its launch (the serving
              path's C3 decode), against its plain
              PyTorch version on the card, at the shapes both serve phases
              give them: smollm-135m's packed step (Hkv 3, group 3, D 64, page
              16, 8 sequences with contexts 0..2048, a 512-token prefill
              region with a resumed chunk; plus a non-power-of-two page,
              24) and zamba2-1.2b's padded step (Hkv 32, group 1, D 64,
              page 16, 8 decode rows with contexts up to 1056 on the
              segmented variant with 16 segments, a fresh prefill of 8 x
              1024 rows at context 0 in the uniform layout), at
              qwen2.5-3b's heads (Hkv 2, group 8, D 128: the D 128
              instantiation of the tensor-core prefill, and 128 rows a
              Q-Block, over 64) and, for the decode kernels only, at
              glm4-9b's heads (Hkv 2, group 16, D 128: the largest group
              the repo's models give them), in fp32 with TF32 off (atol
              1e-4) and bf16 (atol 2e-2: a bf16 output ulp near 1 is
              7.8e-3, and p is rounded to bf16 before p.V on both sides;
              bf16 prefill runs the tensor-core kernel, fp32 the scalar
              one); a context-0 decode row is exact zeros and every
              segment without a live key exactly (acc 0, m NEG, l 0); the
              folded launch gives the bits of the segmented kernel
              followed by the standalone merge
  4. time     median kernel time over CUDA events (L2 flushed before each
              launch; the events also time the wrapper's host enqueue
              where it outlasts the flush, so the wrapper's host time is
              logged beside it as host_us) beside the plain version, a
              library yardstick and the bound (bytes at 3.35 TB/s or
              FLOPs at peak); further `time` rows, logged only: the
              Q-Block prefill and both decode kernels at zamba2-1.2b's
              shapes (padded prefill; Hkv 32, group 1 decode), both
              decode kernels at qwen2.5-3b's heads (D 128, group 8); the
              folded C3 launch beside the two launches it replaces (the
              `segment_reduce` row of the kernels' JSON is the folded
              launch)
  5. serve    full-width smollm-135m (bf16, random seeded weights) serves
              8 requests (prompts 128-1024, 32 new tokens, max_seqs 8,
              chunked prefill; one request sampled with temperature,
              top-k and top-p) through the packed fused step, captured
              into CUDA graphs and replayed (the engine's default); the
              kernel launch counters are zeroed just before and read just
              after: every paged kernel launched, each C3 decode one
              launch of the folded kernel (`KERNEL_LAUNCHES`: the
              partial-only kernel and the standalone merge never).  Then
              the same requests eagerly (`cuda_graphs=False`): identical
              tokens, launch counters and `compile_events`, logits bit for
              bit (else within one bf16 ulp of the largest logit), both
              walls, the captures and replays and the steps' walls by kind
              logged (`graphs_vs_eager`); and the same differential on a
              preempting trace (4 requests on 13 pages)
  6. diff     full width in fp32 (TF32 off): 3 greedy requests of 8 new
              tokens on the card (CUDA kernels, CUDA graphs) and on the
              CPU (plain versions), stepped in lockstep: identical tokens,
              logits within 5e-3; then one bf16 prefill of the same 3
              prompts on the card, replaying the packed step's graph (the
              prompts are served once before to capture it), and on the
              CPU: the logit gap within 2 x the CPU's own bf16-vs-fp32 gap
  7. flash    the flash-attention forward kernel (o and lse) against its
              plain version on the card at the shape the train phase gives
              it (B 4, S 2048, Hq 9, Hkv 3, D 64, causal, packed q
              [12, 128, 48, 64]; fp32 and bf16), at qwen2.5-3b's heads
              (Hq 16, Hkv 2, D 128: the D 128 tensor-core instantiation;
              fp32 and bf16) and the five shapes of
              tests/test_kernels_flash_attention.py (atol 1e-4 fp32 with
              TF32 off, 2e-2 bf16; bf16 runs the tensor-core kernel, fp32
              the scalar one), and the gradient of flash attention
              (kernel forward + recompute backward) on the card against the
              same on the CPU (fp32, atol 1e-4)
  8. ftime    the flash kernel at B 4, S 2048, Hq 9, Hkv 3, D 64, bf16,
              causal, beside its plain version,
              scaled_dot_product_attention (a yardstick, never called by the
              port) and its bound
  9. train    full-width, full-depth smollm-135m in bf16 (random weights
              from seed 0) takes 1 + 5 AdamW steps at batch 4 x seq 2048 on
              Markov data (seed 1) through `trainer.train_step`; the launch
              counters are zeroed just before and read just after: the
              flash kernel runs 2 x 30 x 6 times (each block's forward and
              its remat recompute), the paged kernels never
 10. tdiff    full width in fp32 (TF32 off): 3 train steps at batch 2 x
              seq 256 on the card and on the CPU from the same weights and
              batches: losses within 1e-4 relative, grad norms within 1e-3
 11. ssd      the Mamba2 SSD kernel (y and the final state) against its
              plain version on the card, from a nonzero initial state: at
              the shape the hybrid serve phase gives it (B 8, L 1024, H 32,
              P 128, N 64, G 1, chunk 128), at a short prompt (L 16, chunk
              16), at the cases of tests/test_kernels_mamba2.py, at the
              card tests' cases across the bf16 kernel's MMA tiles (P 48 /
              N 24 / Q 24, P 40 / N 8 / Q 40, P 20 / N 12 / Q 12) and from
              a state of ~100 under x of ~0.01; fp32 (the scalar kernel)
              with TF32 off within 1e-5 x max |y| (sums of up to 128 x 64
              products of values as large as |y|, in another order), bf16
              (the tensor-core kernel, fp32 operands as bf16 hi + lo
              halves) within 2e-2
 12. ssdtime  the SSD kernel at the serve shape in bf16 beside its plain
              version and its bound; no single PyTorch call computes the
              SSD, so its library time is null
 13. hserve   full-width zamba2-1.2b (bf16, random seeded weights) serves 8
              requests (prompts 128-1024, 32 new tokens, max_seqs 8)
              through the padded per-kind step; the launch counters are
              zeroed just before and read just after: the SSD runs once
              per Mamba2 layer per prefill (32 x, every launch the
              tensor-core kernel), the Q-Block prefill once
              per shared-attention invocation per prefill (6 x), the decode
              kernels 6 x per decode step (one launch: a segmented step's
              partials and merge are one folded kernel; the decode step is
              a replayed CUDA graph, the prefill eager), the flash kernel
              never; the configs the engine picked are the ones phase 3
              checked; then phase 5's differential against the same
              requests served eagerly
 14. hdiff    zamba2 at full width cut to 12 layers (two groups of five
              Mamba2 blocks and the shared block), fp32 (TF32 off): 3
              greedy requests of 8 new tokens on the card and on the CPU,
              stepped in lockstep: identical tokens, logits within 5e-3;
              then one prefill of the same 3 requests in bf16 on the card
              (the tensor-core SSD) and on the CPU: the last-token logits'
              max abs gap within 2 x the CPU's own bf16-vs-fp32 gap in the
              same run, argmax agreement logged
 15. mlstm    the chunked mLSTM kernel (h and the final C, n, m) against
              its plain version on the card: at the shape the xlstm serve
              phase gives it (B 8, L 1024, H 4, P 512, chunk 64) from the
              empty state (m = -inf) and from a nonzero finite state, at a
              short prompt (L 16, chunk 16), at the cases of
              tests/test_kernels_mlstm.py with its extreme gates, and with
              padded rows (ig -30 / fg +30 past each row's length); fp32
              with TF32 off within 2e-5 x max |out| per output (h divides
              sums of up to 64 + 512 products, summed in another order, by
              a denominator that can sit at its exp(-m) floor), bf16
              inputs (the tensor-core kernel) within 2e-5 for the fp32
              state and 8e-3 x max |h| for h (rounded to bf16 on both
              sides: one ulp is at most 2^-7 of the value); also the card
              tests' cases across the MMA tiles (P 16 / Q 8, P 40 / Q 24,
              P 20 / Q 12, P 136) and a state of ~100 under q, k, v of
              ~0.01 ("large")
 16. mltime   the mLSTM kernel at the serve shape in bf16 beside its plain
              version and its bound; no single PyTorch call computes the
              chunked mLSTM, so its library time is null
 17. xserve   full-width, full-depth xlstm-350m (bf16, random seeded
              weights) serves 8 requests (prompts 128-1024, 32 new tokens,
              max_seqs 8) through the padded per-kind step; the launch
              counters are zeroed just before and read just after: the
              mLSTM kernel runs once per mLSTM layer per prefill (21 x,
              every launch the tensor-core kernel), the paged, flash and
              SSD kernels never (the decode step a replayed CUDA graph);
              then phase 5's differential against the same requests
              served eagerly
 18. xdiff    xlstm at full width cut to 8 layers (one group: seven mLSTM
              blocks and one sLSTM block), fp32 (TF32 off): 3 greedy
              requests of 8 new tokens on the card and on the CPU, stepped
              in lockstep: identical tokens, logits within 5e-3; then the
              bf16 leg of phase 14 (the tensor-core mLSTM)

Each phase logs its duration (`phase <n> <name> <s>s`).  The line before
the last is `nvidia-smi`'s name and power limit, the one before that the
kernels' JSON; the last line is the result JSON.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0
ARCH = "smollm-135m"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, H100 SXM
KERNEL_SOURCE = "src/repro_torch/csrc/paged_attention.cu"
REPLACES = {
    "paged_decode": "src/repro/kernels/paged_attention/kernel.py:169",
    "paged_decode_segmented": "src/repro/kernels/paged_attention/kernel.py:279",
    "segment_reduce": "src/repro/kernels/paged_attention/kernel.py:359",
    "paged_prefill_qblock": "src/repro/kernels/paged_attention/kernel.py:454",
}
# the serving path's C3 decode (segmented partials and merge in one
# launch), and the two launches it replaces, timed as one call
MERGED = "paged_decode_segmented_merged"
PAIR = "paged_decode_segmented+segment_reduce"
FLASH = "flash_attention_fwd"
FLASH_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:96"
ATOL = {"float32": 1e-4, "bfloat16": 2e-2}
DEVICE = "cuda"
# the paged kernels' check shapes, one set per serve phase: the model whose
# heads they are, the page sizes, the decode contexts (8 rows) and the
# decode variant's segment count, the prefill's per-sequence query rows and
# contexts (qlens None: the decode kernels only), and its layout (`stride`
# None: packed back to back as in the packed step's chunk region; else
# starts at that stride, the padded step's uniform layout)
PAGED_SHAPES = {
    "smollm-135m": dict(
        page_sizes=(16, 24), ctx=(0, 1, 17, 100, 511, 1000, 1500, 2048),
        num_segments=16, qlens=(200, 312, 0, 0, 0, 0, 0, 0),
        pf_ctx=(200, 1312, 0, 0, 0, 0, 0, 0), stride=None),
    # phase 13: 8 prompts of 128-1024 tokens in one fresh prefill padded
    # to 1024 rows each, then 31 decode steps (contexts up to 1055); its
    # decode profile (8 rows, max context 2048, page 16) picks segmented
    # with 16 segments, its prefill profile block_q 16
    "zamba2-1.2b": dict(
        page_sizes=(16,), ctx=(1056, 129, 300, 517, 640, 777, 901, 1033),
        num_segments=16, qlens=(1024, 128, 517, 1000, 256, 771, 390, 1023),
        pf_ctx=(1024, 128, 517, 1000, 256, 771, 390, 1023), stride=1024),
    # no serve phase: qwen2.5-3b's heads (Hkv 2, group 8, D 128) hold the
    # D 128 kernels, and a Q-Block of 16 x 8 = 128 rows, against their
    # plain versions; a resumed and a fresh chunk, dead Q-blocks
    "qwen2.5-3b": dict(
        page_sizes=(16,), ctx=(0, 1, 33, 300, 777, 1024, 1500, 2048),
        num_segments=16, qlens=(100, 37, 0, 0, 0, 0, 0, 0),
        pf_ctx=(900, 37, 0, 0, 0, 0, 0, 0), stride=None),
    # no serve phase: glm4-9b's heads (Hkv 2, group 16, D 128), the largest
    # group the repo's models give the decode kernels (two blocks of 8
    # rows); contexts on a segment (640) and a page boundary (1024), and at
    # the full 2048; the prefill is held at 128 rows by qwen2.5-3b's set
    "glm4-9b": dict(
        page_sizes=(16,), ctx=(0, 1, 33, 640, 1024, 1500, 2047, 2048),
        num_segments=16, qlens=None, pf_ctx=None, stride=None),
}
PAGED_BLOCK_Q = 16
DIFF_LOGIT_ATOL = 5e-3
# graphed against eager steps of one engine configuration: the same kernels
# on the same inputs, so bit-equal logits are expected; a cuBLAS algorithm
# chosen differently under capture would show as a difference, allowed up
# to this (fp32) or one bf16 ulp of the largest logit (bf16)
GRAPH_LOGIT_ATOL = 1e-5
# the sampled request pins its RNG stream (else its request id, which
# differs between the two runs)
SERVE_SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.9, seed=3)
# phase 5's preempting trace: 13 pages of 16 (12 usable) for four requests
# that need ~18, as in tests/test_torch_engine.py
PREEMPT_LENS, PREEMPT_NEW_TOKENS = (40, 33, 47, 20), 24
PREEMPT_ENGINE = dict(max_seqs=4, num_pages=13, max_model_len=128)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 5  # + 1 untimed warm-up step
# flash check shapes: (B, Sq, Skv, Hq, Hkv, D, causal, q_offset, dtype); the
# shape the train phase gives the kernel (smollm-135m: Hq 9, Hkv 3, D 64),
# then the cases of tests/test_kernels_flash_attention.py, then D 128
FLASH_TRAIN_CASE = (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 9, 3, 64, True, 0,
                    "bfloat16")
FLASH_CASES = [
    FLASH_TRAIN_CASE[:-1] + ("float32",),
    FLASH_TRAIN_CASE,
    (2, 128, 128, 4, 2, 64, True, 0, "float32"),
    (1, 64, 64, 8, 8, 128, True, 0, "float32"),
    (2, 32, 128, 4, 1, 64, True, 96, "float32"),
    (1, 128, 128, 16, 2, 128, False, 0, "float32"),
    (2, 128, 128, 4, 2, 64, True, 0, "bfloat16"),
    (1, 512, 512, 16, 2, 128, True, 0, "float32"),  # qwen2.5-3b's heads
    (1, 512, 512, 16, 2, 128, True, 0, "bfloat16"),
]
FLASH_GRAD_CASE = (2, 256, 256, 9, 3, 64, True, 0, "float32")
SSD = "ssd_chunked_fwd"
SSD_SOURCE = "src/repro_torch/csrc/mamba2_ssd.cu"
SSD_REPLACES = "src/repro/kernels/mamba2/kernel.py:81"
HYBRID_ARCH = "zamba2-1.2b"
HYBRID_REQUESTS, HYBRID_NEW_TOKENS = 8, 32
# SSD check shapes (B, L, H, P, N, G, chunk): the shape the hybrid serve
# phase gives the kernel (8 prompts of up to 1024 tokens in one prefill,
# zamba2's widths), a short prompt, then tests/test_kernels_mamba2.py's
SSD_SERVE_CASE = (HYBRID_REQUESTS, 1024, 32, 128, 64, 1, 128)
SSD_CASES = [SSD_SERVE_CASE, (1, 16, 32, 128, 64, 1, 16),
             (2, 64, 4, 32, 16, 2, 16), (1, 128, 2, 64, 64, 1, 32),
             (2, 32, 8, 16, 8, 8, 8),
             # the card tests' cases across the bf16 kernel's MMA tiles:
             # P 48 / N 24 / Q 24, P 40 / N 8 / Q 40, and P 20 / N 12 / Q 12
             # (rows that are no multiple of 16 bytes: element-wise copies)
             (1, 96, 3, 48, 24, 3, 24), (2, 80, 2, 40, 8, 1, 40),
             (1, 36, 2, 20, 12, 2, 12)]
# an initial state of ~100 under x of ~0.01: y ~ exp(a) C S_in up to ~10^3,
# where one bf16 rounding of S_in would miss the absolute 2e-2 (the bf16
# kernel's hi + lo halves keep ~2^-17)
SSD_LARGE_STATE_CASE = (2, 256, 4, 128, 64, 1, 128)
SSD_FP32_RTOL, SSD_BF16_ATOL = 1e-5, 2e-2
HDIFF_LAYERS = 12
MLSTM = "mlstm_chunked_fwd"
MLSTM_SOURCE = "src/repro_torch/csrc/mlstm_chunked.cu"
MLSTM_REPLACES = "src/repro/kernels/mlstm/kernel.py:94"
XLSTM_ARCH = "xlstm-350m"
XLSTM_REQUESTS, XLSTM_NEW_TOKENS = 8, 32
# mLSTM check cases (B, L, H, P, chunk, gates, state): the shape the xlstm
# serve phase gives the kernel (8 prompts of up to 1024 tokens in one
# prefill, xlstm-350m's 4 heads of 512, chunk 64) from the empty and from
# a nonzero state, a short prompt, tests/test_kernels_mlstm.py's cases and
# extreme gates, and padded rows; gates "normal" are drawn as that test
# file draws them (forget-gate bias 2)
MLSTM_SERVE_CASE = (XLSTM_REQUESTS, 1024, 4, 512, 64, "normal", "empty")
MLSTM_CASES = [MLSTM_SERVE_CASE,
               MLSTM_SERVE_CASE[:-1] + ("nonzero",),
               (XLSTM_REQUESTS, 16, 4, 512, 16, "normal", "empty"),
               (2, 64, 3, 16, 16, "normal", "empty"),
               (1, 128, 4, 64, 32, "normal", "nonzero"),
               (2, 32, 1, 32, 8, "normal", "empty"),
               (1, 32, 2, 16, 8, "extreme", "empty"),
               (4, 128, 4, 512, 64, "padded", "empty"),
               # the card tests' cases across the bf16 kernel's MMA tiles:
               # P 16 / Q 8, P 40 / Q 24, P 20 / Q 12 (element-wise
               # copies), P 136 (a ragged third column block); and a state
               # of ~100 under q, k, v of ~0.01 ("large")
               (2, 24, 2, 16, 8, "normal", "empty"),
               (1, 48, 2, 40, 24, "normal", "nonzero"),
               (1, 24, 1, 20, 12, "normal", "empty"),
               (1, 64, 2, 136, 32, "normal", "nonzero"),
               (2, 128, 2, 64, 32, "normal", "large")]
MLSTM_PAD_LENS = (128, 100, 37, 0)  # valid tokens per row of "padded"
MLSTM_FP32_RTOL, MLSTM_BF16_H_RTOL = 2e-5, 8e-3
XDIFF_LAYERS = 8
# the bf16 legs of phases 14 and 18: the card's bf16 prefill logits within
# this multiple of the CPU's own bf16-vs-fp32 gap, measured in the same run
BF16_GAP_FACTOR = 2.0
TRAIN_KW = dict(base_lr=1e-3, warmup=1, total_steps=100)
# 3 steps: the schedule gives step 0 a learning rate of 0, so step 2 is
# the first whose loss follows an update.  The loss is a mean over 512
# tokens and the grad norm a sum over 135M squares, each after 30 layers
# of fp32 GEMMs summed in another order on each side (~1e-6 relative
# expected): 1e-4 and 1e-3 leave room without hiding a wrong kernel.
TDIFF_BATCH, TDIFF_SEQ, TDIFF_STEPS = 2, 256, 3
TDIFF_LOSS_RTOL, TDIFF_GNORM_RTOL = 1e-4, 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# inputs at the main path's shapes
# ---------------------------------------------------------------------------


def decode_inputs(torch, dtype, ps, *, hkv=3, group=3, d=64,
                  ctx=(0, 1, 17, 100, 511, 1000, 1500, 2048),
                  max_model_len=2048, seed=1):
    g = torch.Generator(device="cpu").manual_seed(seed)
    s = len(ctx)
    np_ = -(-max_model_len // ps)
    p = s * np_ + 1
    q = torch.randn((s, hkv * group, d), generator=g).to(dtype)
    kp = torch.randn((hkv, p, ps, d), generator=g).to(dtype)
    vp = torch.randn((hkv, p, ps, d), generator=g).to(dtype)
    pt = (torch.randperm(p - 1, generator=g)[: s * np_].reshape(s, np_)
          + 1).to(torch.int32)
    dev = DEVICE
    return (q.to(dev), kp.to(dev), vp.to(dev), pt.to(dev),
            torch.tensor(ctx, dtype=torch.int32, device=dev))


def prefill_inputs(torch, tops, dtype, ps, *, hkv, group, d, qlens, ctx,
                   stride, block_q=PAGED_BLOCK_Q, max_model_len=2048,
                   seed=2):
    """Q-Block prefill inputs: sequence i has qlens[i] query rows ending at
    context ctx[i], packed back to back (stride None: the packed step's
    chunk region) or starting at i * stride (the padded step's uniform
    layout); q_packed / qb metadata as ops.paged_attention_prefill builds
    them."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    ms = len(qlens)
    qlens, ctx = list(qlens), list(ctx)
    t = sum(qlens) if stride is None else ms * stride
    np_ = -(-max_model_len // ps)
    p = ms * np_ + 1
    kp = torch.randn((hkv, p, ps, d), generator=g).to(dtype)
    vp = torch.randn((hkv, p, ps, d), generator=g).to(dtype)
    pt = (torch.randperm(p - 1, generator=g)[: ms * np_].reshape(ms, np_)
          + 1).to(torch.int32)
    qlens_t = torch.tensor(qlens, dtype=torch.int32)
    if stride is None:
        qsl = torch.cat([torch.zeros(1, dtype=torch.int32),
                         torch.cumsum(qlens_t, 0, dtype=torch.int32)])
    else:
        qsl = torch.arange(ms + 1, dtype=torch.int32) * stride
    ctx_t = torch.tensor(ctx, dtype=torch.int32)
    nqb = t // block_q + ms
    qb_seq, qb_pos0, _, _ = tops.build_qblock_metadata(
        qsl, qlens_t, ctx_t, block_q=block_q, num_q_blocks=nqb)
    q_packed = torch.randn((nqb, hkv, block_q * group, d), generator=g).to(
        dtype)
    dev = DEVICE
    return dict(q_packed=q_packed.to(dev), k=kp.to(dev), v=vp.to(dev),
                qb_seq=qb_seq.to(dev), qb_pos0=qb_pos0.to(dev),
                pt=pt.to(dev), ctx=ctx_t.to(dev), block_q=block_q,
                group=group, qlens=qlens)


def tile_view(pages, tile):
    hkv, p, ps, d = pages.shape
    return pages.reshape(hkv, p, ps // tile, tile, d)


# ---------------------------------------------------------------------------
# one call per kernel (kernel wrapper or plain version, same inputs)
# ---------------------------------------------------------------------------


def paged_heads(arch):
    """(hkv, group, head_dim, page_size) of the model a shape set is for."""
    from repro_torch.configs import ARCHS

    cfg = ARCHS[arch]
    return (cfg.num_kv_heads, cfg.num_q_heads // cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.page_size)


def kernel_calls(torch, K, dtype, ps, tile, tops, arch=ARCH):
    """({name: (kernel_fn, plain_fn)}, inputs) at the shapes arch's serve
    phase gives the kernels (PAGED_SHAPES); both functions of a pair take
    the same tensors."""
    shp = PAGED_SHAPES[arch]
    hkv, group, d, _ = paged_heads(arch)
    q, kp, vp, pt, ctx = decode_inputs(torch, dtype, ps, hkv=hkv,
                                       group=group, d=d, ctx=shp["ctx"])
    s, hq, _ = q.shape
    kt, vt = tile_view(kp, tile), tile_view(vp, tile)
    num_tiles = pt.shape[1] * (ps // tile)
    nseg = min(shp["num_segments"], num_tiles)
    tps = -(-num_tiles // nseg)
    scale = d ** -0.5
    qg = q.reshape(s, hkv, group, d).contiguous()
    qb = q.reshape(s, hq, 1, d).contiguous()
    seg_kw = dict(num_segments=nseg, tiles_per_segment=tps, scale=scale)
    parts = K.paged_decode_segmented(qg, kt, vt, pt, ctx, **seg_kw)
    calls = {
        "paged_decode": (
            lambda: K.paged_decode(qg, kt, vt, pt, ctx, cells_per_kv=1,
                                   scale=scale),
            lambda: K.paged_decode_plain(qg, kt, vt, pt, ctx, cells_per_kv=1,
                                         scale=scale)),
        "paged_decode[baseline]": (
            lambda: K.paged_decode(qb, kt, vt, pt, ctx, cells_per_kv=group,
                                   scale=scale),
            lambda: K.paged_decode_plain(qb, kt, vt, pt, ctx,
                                         cells_per_kv=group, scale=scale)),
        "paged_decode_segmented": (
            lambda: K.paged_decode_segmented(qg, kt, vt, pt, ctx, **seg_kw),
            lambda: K.paged_decode_segmented_plain(qg, kt, vt, pt, ctx,
                                                   **seg_kw)),
        "segment_reduce": (
            lambda: K.segment_reduce(*parts, dtype),
            lambda: K.segment_reduce_plain(*parts, dtype)),
        MERGED: (
            lambda: K.paged_decode_segmented_merged(qg, kt, vt, pt, ctx,
                                                    **seg_kw),
            lambda: K.paged_decode_segmented_merged_plain(qg, kt, vt, pt, ctx,
                                                          **seg_kw)),
    }
    pf = None
    if shp["qlens"] is not None:
        pf = prefill_inputs(torch, tops, dtype, ps, hkv=hkv, group=group,
                            d=d, qlens=shp["qlens"], ctx=shp["pf_ctx"],
                            stride=shp["stride"])
        pkt, pvt = tile_view(pf["k"], tile), tile_view(pf["v"], tile)
        pf_args = (pf["q_packed"], pkt, pvt, pf["qb_seq"], pf["qb_pos0"],
                   pf["pt"], pf["ctx"])
        pf_kw = dict(block_q=pf["block_q"], group=pf["group"], scale=scale)
        calls["paged_prefill_qblock"] = (
            lambda: K.paged_prefill_qblock(*pf_args, **pf_kw),
            lambda: K.paged_prefill_qblock_plain(*pf_args, **pf_kw))
    return calls, dict(q=q, kp=kp, vp=vp, pt=pt, ctx=ctx, nseg=nseg,
                       tps=tps, pf=pf, parts=parts, tile=tile, ps=ps)


def max_err(torch, name, got, want):
    """Max abs error; the segmented partials are compared as acc / l
    (the unnormalised accumulator grows with the context) plus m, l."""
    if name == "paged_decode_segmented":
        (o, m, l), (o2, m2, l2) = got, want
        norm = lambda a, b: a / torch.where(b == 0, 1.0, b)[..., None]  # noqa: E731
        errs = [(norm(o, l) - norm(o2, l2)).abs().max(),
                (m - m2).abs().max(),
                ((l - l2).abs() / l2.clamp_min(1.0)).max()]
        return max(float(e) for e in errs)
    return float((got.float() - want.float()).abs().max())


def dead_segments_exact(torch, x):
    """True when every segment without a live key holds exactly m = NEG,
    l = 0 and acc = 0 (segment_reduce's dead test m <= NEG / 2 and its
    exact zeros rely on it); fails too if the shape has no dead segment."""
    from repro_torch.kernels._common import NEG_INF

    o, m, l = x["parts"]
    start = torch.arange(x["nseg"], device=m.device) * x["tps"] * x["tile"]
    dead = start[None, :] >= x["ctx"][:, None]  # [S, nseg]
    return bool(dead.any()) \
        and bool((m.permute(0, 2, 1, 3)[dead] == NEG_INF).all()) \
        and bool((l.permute(0, 2, 1, 3)[dead] == 0).all()) \
        and bool((o.permute(0, 2, 1, 3, 4)[dead] == 0).all())


def same_bits(torch, a, b):
    """True when a and b hold the same bits (not merely equal values)."""
    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def phase_check(torch, K, tops):
    """Each paged kernel against its plain version at both serve phases'
    shapes and at qwen2.5-3b's and glm4-9b's heads, and the folded C3
    launch against the two launches it replaces, bit for bit; returns
    each kernel's worst error over all of them."""
    errs: dict[str, float] = {}
    for arch, shp in PAGED_SHAPES.items():
        hkv, group, d, page_size = paged_heads(arch)
        if page_size not in shp["page_sizes"]:
            raise AssertionError(f"PAGED_SHAPES[{arch!r}] misses the "
                                 f"model's page size {page_size}")
        for ps in shp["page_sizes"]:
            for dtype_name in ("float32", "bfloat16"):
                dtype = getattr(torch, dtype_name)
                tile = tops.default_tile(ps)
                calls, x = kernel_calls(torch, K, dtype, ps, tile, tops, arch)
                for name, (kfn, pfn) in calls.items():
                    got = kfn()
                    want = pfn()
                    torch.cuda.synchronize()
                    err = max_err(torch, name, got, want)
                    ok = err <= ATOL[dtype_name]
                    log(f"check {name:29s} {arch:12s} Hkv {hkv:2d} group "
                        f"{group} D {d} {dtype_name:8s} page {ps:2d} tile "
                        f"{tile:2d}  max_abs_err {err:.3e}  atol "
                        f"{ATOL[dtype_name]:g}  {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(
                            f"{name} disagrees with its plain version "
                            f"({arch} shapes, {dtype_name}, page {ps})")
                    base = name.split("[")[0]
                    errs[base] = max(errs.get(base, 0.0), err)
                merged = calls[MERGED][0]()
                pair = K.segment_reduce(*calls["paged_decode_segmented"][0](),
                                        dtype)
                torch.cuda.synchronize()
                if not same_bits(torch, merged, pair):
                    raise AssertionError(
                        f"{MERGED} differs from paged_decode_segmented + "
                        f"segment_reduce ({arch}, {dtype_name}, page {ps}): "
                        f"max abs diff "
                        f"{float((merged.float() - pair.float()).abs().max())}")
                log(f"check {MERGED} {arch} {dtype_name} page {ps}: the bits "
                    f"of paged_decode_segmented + segment_reduce")
                if shp["ctx"][0] == 0:  # exact zeros for a dead decode row
                    for out in (calls["paged_decode"][0](), merged):
                        if not bool((out[0] == 0).all()):
                            raise AssertionError("context-0 decode row is "
                                                 "not exact zeros")
                if not dead_segments_exact(torch, x):
                    raise AssertionError(f"a dead segment is not exactly "
                                         f"(acc 0, m NEG, l 0): {arch}, "
                                         f"{dtype_name}, page {ps}")
    return errs


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(torch, fn, iters, flush):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        flush.zero_()  # evict the 50 MB L2: the step finds KV cold
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def host_us(torch, fn, iters=20):
    """Mean host time of one call of `fn` (enqueue only, no sync)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def bounds(name, x, dtype_name):
    """(bound_ms, bound_by): the larger of bytes / HBM rate and FLOPs /
    peak, counting each input read once, each output written once, and
    only the K/V this run's contexts need."""
    e = 2 if dtype_name == "bfloat16" else 4
    q, pt, ctx, tile = x["q"], x["pt"], x["ctx"], x["tile"]
    s, hq, d = q.shape
    hkv = x["kp"].shape[0]
    ctx_l = [int(c) for c in ctx.tolist()]
    live_kv = sum(-(-c // tile) * tile for c in ctx_l)
    meta = pt.numel() * 4 + ctx.numel() * 4
    nseg = x["nseg"]
    m = hq // hkv
    seg_out = s * hkv * nseg * (m * d + 2 * m) * 4
    if name == "paged_decode":
        nbytes = 2 * q.numel() * e + 2 * live_kv * hkv * d * e + meta
        flops = 4 * hq * d * sum(ctx_l)
    elif name == "paged_decode_segmented":
        nbytes = q.numel() * e + 2 * live_kv * hkv * d * e + meta + seg_out
        flops = 4 * hq * d * sum(ctx_l)
    elif name == "segment_reduce":
        nbytes = seg_out + q.numel() * e
        flops = 3 * s * hkv * nseg * m * d
    elif name in (MERGED, PAIR):  # the partials are workspace
        nbytes = 2 * q.numel() * e + 2 * live_kv * hkv * d * e + meta
        flops = 4 * hq * d * sum(ctx_l) + 3 * s * hkv * nseg * m * d
    else:  # paged_prefill_qblock
        pf = x["pf"]
        pctx = [int(c) for c in pf["ctx"].tolist()]
        live = sum(-(-c // tile) * tile for c in pctx)
        nbytes = (2 * pf["q_packed"].numel() * e + 2 * live * hkv * d * e
                  + pf["pt"].numel() * 4 + 2 * pf["qb_seq"].numel() * 4)
        keys = 0  # causal keys per live query row
        for c, ql in zip(pctx, pf["qlens"]):
            start = c - ql
            keys += sum(start + i + 1 for i in range(ql))
        flops = 4 * hq * d * keys
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_calls(torch, x):
    """One PyTorch yardstick per kernel where one computes the same
    function: a page gather + scaled_dot_product_attention (timed only,
    never used by the port)."""
    F = torch.nn.functional
    q, kp, vp, pt, ctx = x["q"], x["kp"], x["vp"], x["pt"], x["ctx"]
    s, hq, d = q.shape
    hkv, _, ps, _ = kp.shape
    group = hq // hkv
    length = pt.shape[1] * ps
    pos = torch.arange(length, device=q.device)
    dmask = (pos[None, :] < ctx[:, None].long())[:, None, None, :]
    pt_l = pt.long()

    def decode():
        k = kp[:, pt_l].reshape(hkv, s, length, d).transpose(0, 1)
        v = vp[:, pt_l].reshape(hkv, s, length, d).transpose(0, 1)
        k = k.repeat_interleave(group, 1)
        v = v.repeat_interleave(group, 1)
        return F.scaled_dot_product_attention(q[:, :, None], k, v,
                                              attn_mask=dmask)

    pf = x["pf"]
    qp, qb_seq, qb_pos0 = pf["q_packed"], pf["qb_seq"], pf["qb_pos0"]
    nqb, _, bm, _ = qp.shape
    seq_c = qb_seq.clamp_min(0).long()
    ppt = pf["pt"].long()[seq_c]  # [NQB, Np]
    pctx = pf["ctx"].long()[seq_c]
    q_pos = qb_pos0.long()[:, None] + torch.arange(bm, device=q.device) \
        // pf["group"]
    pmask = ((pos[None, None, :] < pctx[:, None, None])
             & (pos[None, None, :] <= q_pos[:, :, None]))[:, None]

    def prefill():
        k = pf["k"][:, ppt].reshape(hkv, nqb, length, d).transpose(0, 1)
        v = pf["v"][:, ppt].reshape(hkv, nqb, length, d).transpose(0, 1)
        return F.scaled_dot_product_attention(qp, k, v, attn_mask=pmask)

    # the folded C3 launch, alone or as two, computes decode's function
    return {"paged_decode": decode, MERGED: decode, PAIR: decode,
            "paged_prefill_qblock": prefill}


def phase_time(torch, K, tops, dtype_name="bfloat16", iters=20):
    """Each paged kernel and the folded C3 launch at smollm's serve shapes
    (the rows of the kernels' JSON), the two launches it folds timed as
    one call, then, logged only, the Q-Block prefill and the decode
    kernels at zamba2's shapes and the decode kernels at qwen2.5-3b's
    heads."""
    dtype = getattr(torch, dtype_name)
    ps = 16
    tile = tops.default_tile(ps)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def row(name, calls, lib, x, arch):
        kfn, pfn = calls[name]
        ms = time_ms(torch, kfn, iters, flush)
        plain_ms = time_ms(torch, pfn, 3, flush)
        lib_ms = time_ms(torch, lib[name], iters, flush) if name in lib \
            else None
        bound_ms, bound_by = bounds(name, x, dtype_name)
        log(f"time  {name:37s} {arch:12s} {dtype_name} kernel_ms {ms:.4f}  "
            f"plain_ms {plain_ms:.4f}  library_ms "
            f"{'null' if lib_ms is None else f'{lib_ms:.4f}'}  bound_ms "
            f"{bound_ms:.5f} ({bound_by})  host_us "
            f"{host_us(torch, kfn):.1f}")
        return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=bound_ms, bound_by=bound_by)

    calls, x = kernel_calls(torch, K, dtype, ps, tile, tops)
    calls[PAIR] = (lambda: K.segment_reduce(
        *calls["paged_decode_segmented"][0](), dtype), calls[MERGED][1])
    lib = library_calls(torch, x)
    rows = {name: row(name, calls, lib, x, ARCH)
            for name in (*REPLACES, MERGED, PAIR)}
    del calls, x, lib
    for arch, names in ((HYBRID_ARCH, ("paged_prefill_qblock", "paged_decode",
                                       "paged_decode_segmented", MERGED)),
                        ("qwen2.5-3b", ("paged_decode",
                                        "paged_decode_segmented", MERGED))):
        calls, x = kernel_calls(torch, K, dtype, ps, tile, tops, arch)
        lib = library_calls(torch, x)
        for name in names:
            row(name, calls, lib, x, arch)
        del calls, x, lib
    return rows


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------


def check_paged_routes(K, launches, tag, dtype):
    """The paged kernels a serving run launched, by device kernel: every
    C3 decode one folded launch (the partial-only kernel and the
    standalone merge never), every prefill the kernel of the model's dtype
    (bf16: the tensor-core kernel)."""
    mma = dtype == "bfloat16"
    want = {"decode_stream_kernel": launches["paged_decode"],
            "decode_stream_seg_kernel": 0,
            "decode_stream_seg_merge_kernel": launches["segment_reduce"],
            "segment_reduce_kernel": 0,
            "prefill_mma_kernel": launches["paged_prefill_qblock"] * mma,
            "prefill_kernel": launches["paged_prefill_qblock"] * (not mma)}
    log(f"{tag} paged kernels {K.KERNEL_LAUNCHES}")
    if K.KERNEL_LAUNCHES != want \
            or launches["paged_decode_segmented"] != launches["segment_reduce"]:
        raise AssertionError(f"paged kernels {K.KERNEL_LAUNCHES} != {want} "
                             f"(launches {launches})")


def serve_run(torch, eng, reqs, tag):
    """Serve `reqs` on `eng` to the end.  Every kernel launch counter is
    zeroed just before and read just after.  Each step ends in the host
    copy of its sampled ids (a synchronisation), so its host wall is its
    time; a step is "captured" when it captured a CUDA graph, "replayed"
    when it replayed one and captured none, else "eager".  Returns the
    steps' stats, their logits (the engine's debug copies, kept on the
    card), the wall, each step's wall, the walls by kind and the
    counters."""
    from repro_torch.serving.cuda_graphs import kernel_counters

    for r in reqs:
        eng.add_request(r)
    for counts in kernel_counters():
        counts.update(dict.fromkeys(counts, 0))
    torch.cuda.synchronize()
    stats, logits, walls = [], [], []
    split = {kind: [0, 0.0] for kind in ("captured", "replayed", "eager")}
    t0 = time.perf_counter()
    while eng.sched.has_work and len(stats) < 1000:
        before = dict(eng.graph_stats)
        t_step = time.perf_counter()
        stats.append(eng.step())
        dt = time.perf_counter() - t_step
        walls.append(dt)
        kind = ("captured" if eng.graph_stats["captures"] > before["captures"]
                else "replayed" if eng.graph_stats["replays"]
                > before["replays"] else "eager")
        split[kind][0] += 1
        split[kind][1] += dt
        logits.append(eng.last_step_logits)
        if not bool(torch.isfinite(eng.last_step_logits).all()):
            raise AssertionError(f"{tag}: non-finite logits at step "
                                 f"{len(stats)}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(eng=eng, reqs=reqs, stats=stats, logits=logits, wall=wall,
                step_walls=walls, split=split,
                counts=[dict(c) for c in kernel_counters()])


def graphs_vs_eager(torch, tag, g, e, dtype):
    """The graphed run `g` (the engine's default) against the eager run `e`
    (`cuda_graphs=False`) of the same requests: identical tokens (prompts
    too: a preemption folds the output into the prompt), launch counters
    and compile_events, and graphs that replayed.  The logits are expected
    bit-equal (a replay runs the captured eager kernels on the same
    inputs); a difference must stay within GRAPH_LOGIT_ATOL (fp32 model)
    or one bf16 ulp of the largest logit (bf16 model).  Logs both walls,
    the captures and replays, and the steps' walls by kind."""
    geng, eeng = g["eng"], e["eng"]
    same_tokens = [(r.prompt, r.output) for r in g["reqs"]] \
        == [(r.prompt, r.output) for r in e["reqs"]]
    same_counts = g["counts"] == e["counts"]
    same_events = geng.compile_events == eeng.compile_events
    bit_equal, worst, top = len(g["logits"]) == len(e["logits"]), 0.0, 0.0
    for a, b in zip(g["logits"], e["logits"]):
        top = max(top, float(b.abs().max()))
        if a.shape != b.shape:
            bit_equal, worst = False, float("inf")
        elif not torch.equal(a, b):
            bit_equal = False
            worst = max(worst, float((a - b).abs().max()))
    bound = GRAPH_LOGIT_ATOL
    if dtype == "bfloat16" and top > 0:
        bound = max(bound, 2.0 ** (math.floor(math.log2(top)) - 7))
    split = " ".join(f"{k} {n} steps {s:.3f}s"
                     for k, (n, s) in g["split"].items())
    log(f"{tag} graphs-vs-eager: wall graphs {g['wall']:.3f}s eager "
        f"{e['wall']:.3f}s  steps {len(g['stats'])}  captures "
        f"{geng.graph_stats['captures']} ({geng.graph_stats['capture_s']:.3f}"
        f"s capturing) replays {geng.graph_stats['replays']}  graphed "
        f"run's steps: {split}  "
        f"eager run's steps {e['split']['eager'][1]:.3f}s")
    log(f"{tag} graphs-vs-eager: tokens_identical {same_tokens}  "
        f"counters_identical {same_counts}  compile_events_identical "
        f"{same_events} ({len(geng.compile_events)})  logits bit_equal "
        f"{bit_equal} max_abs_diff {worst:.3e} (bound {bound:.3e})")
    if not (same_tokens and same_counts and same_events):
        raise AssertionError(f"{tag}: graphs and eager differ: tokens "
                             f"{same_tokens}, counters {same_counts}, "
                             f"compile_events {same_events}")
    if not worst <= bound:
        raise AssertionError(f"{tag}: logits of graphs and eager differ by "
                             f"{worst} > {bound}")
    if not geng.graph_stats["replays"] or eeng.graph_stats["captures"]:
        raise AssertionError(f"{tag}: the graphed run replayed nothing or "
                             f"the eager run captured: {geng.graph_stats}, "
                             f"{eeng.graph_stats}")
    return dict(wall_graphs=g["wall"], wall_eager=e["wall"])


def sampler_cost(torch, s, v, iters=50):
    """What sharing one graph between greedy and sampling steps costs: the
    device time of the packed step's sampler at [S, V], each version
    captured into a CUDA graph and its replays timed over CUDA events (no
    L2 flush: the logits come hot from the head): the filter and draw that
    every graphed step runs, against greedy argmax alone."""
    from repro_torch.models.sampling import sample_tokens

    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    logits = torch.randn((s, v), generator=g, device=DEVICE) * 4
    temps = torch.zeros((s,), device=DEVICE)
    temps[3] = SERVE_SAMPLED["temperature"]
    top_p = torch.full((s,), SERVE_SAMPLED["top_p"], device=DEVICE)
    top_k = torch.full((s,), SERVE_SAMPLED["top_k"], dtype=torch.int32,
                       device=DEVICE)
    noise = torch.rand((s, v), generator=g, device=DEVICE)
    cur = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    ms = {}
    for name, nz in (("filter_and_draw", noise), ("greedy", None)):
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            sample_tokens(logits, temps, top_p, top_k, nz)  # warm-up
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            sample_tokens(logits, temps, top_p, top_k, nz)
        ms[name] = time_ms(torch, graph.replay, iters,
                           torch.empty(1, device=DEVICE))
        del graph
    log(f"serve sampler in a graph at [{s}, {v}]: filter_and_draw "
        f"{ms['filter_and_draw']:.4f} ms, greedy argmax "
        f"{ms['greedy']:.4f} ms a step")
    return ms


def phase_serve(torch, K, FK):
    from repro_torch import weights
    from repro_torch.configs import ARCHS
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request, State

    cfg = ARCHS[ARCH]
    t0 = time.perf_counter()
    model = weights.init_random(cfg, SEED, device=DEVICE)
    log(f"serve {ARCH}: {cfg.num_layers} layers d_model {cfg.d_model} "
        f"heads {cfg.num_q_heads}/{cfg.num_kv_heads} vocab {cfg.vocab_size}"
        f" {cfg.dtype}; weights in {time.perf_counter() - t0:.1f}s")
    eng_kw = dict(max_seqs=8, num_pages=2048, max_model_len=2048,
                  enable_chunked_prefill=True, max_prefill_tokens=512,
                  seed=SEED, debug_logits=True, device=DEVICE)
    g = torch.Generator(device="cpu").manual_seed(SEED)

    def prompts(n, lo, hi):
        lens = torch.randint(lo, hi + 1, (n,), generator=g).tolist()
        return [torch.randint(1, cfg.vocab_size, (n_,), generator=g).tolist()
                for n_ in lens]

    # warm-up (cuBLAS handles, allocator) on a throwaway engine
    warm = Engine(cfg, model, **eng_kw)
    warm.generate([Request(prompt=p, max_new_tokens=4)
                   for p in prompts(2, 40, 200)])
    del warm
    torch.cuda.synchronize()

    served = prompts(8, 128, 1024)

    def requests():  # request 3 samples: temperature, top-k and top-p
        return [Request(prompt=list(p), max_new_tokens=32,
                        **(SERVE_SAMPLED if i == 3 else {}))
                for i, p in enumerate(served)]

    eng = Engine(cfg, model, **eng_kw)
    run = serve_run(torch, eng, requests(), "serve")
    reqs, steps, wall = run["reqs"], len(run["stats"]), run["wall"]
    launches = dict(K.LAUNCHES)
    if not all(r.state is State.FINISHED and len(r.output) == 32
               for r in reqs):
        raise AssertionError("not every request finished")
    if any(n == 0 for n in launches.values()):
        raise AssertionError(f"a kernel was never launched: {launches}")
    if FK.LAUNCHES[FLASH]:
        raise AssertionError("serving launched the training kernel")
    check_paged_routes(K, launches, "serve", cfg.dtype)
    if {v for _, v in eng.dispatch_counts} != {"gqa", "segmented"}:
        raise AssertionError("expected mixed steps on gqa and decode-heavy "
                             f"steps on segmented: {eng.dispatch_counts}")
    toks = sum(len(r.output) for r in reqs)
    prompt_toks = sum(r.num_prompt_tokens for r in reqs)
    log(f"serve steps {steps}  prompt_tokens {prompt_toks}  new_tokens "
        f"{toks}  wall_s {wall:.3f}  new_tok_per_s {toks / wall:.1f}  "
        f"total_tok_per_s {(toks + prompt_toks) / wall:.1f}")
    log(f"serve dispatch_counts {dict(eng.dispatch_counts)}")
    log(f"serve launches {launches}  launched_token_slots "
        f"{eng.launched_token_slots}")
    del eng
    # the same requests on the eager step
    eager = serve_run(torch, Engine(cfg, model, cuda_graphs=False, **eng_kw),
                      requests(), "serve eager")
    walls = graphs_vs_eager(torch, "serve", run, eager, cfg.dtype)
    del run, eager
    # a preempting trace: preemption rewrites the page tables the graphs
    # read from their static buffers
    pre_kw = eng_kw | dict(PREEMPT_ENGINE)
    pre_prompts = [torch.randint(1, cfg.vocab_size, (n,),
                                 generator=g).tolist() for n in PREEMPT_LENS]
    runs = [serve_run(torch, Engine(cfg, model, cuda_graphs=graphs,
                                    **pre_kw),
                      [Request(prompt=list(p),
                               max_new_tokens=PREEMPT_NEW_TOKENS)
                       for p in pre_prompts], f"preempt graphs={graphs}")
            for graphs in (True, False)]
    preempted = sum(st["preempted"] for st in runs[0]["stats"])
    log(f"serve preempt: {len(PREEMPT_LENS)} requests on "
        f"{PREEMPT_ENGINE['num_pages']} pages, {preempted} preemptions")
    if not preempted:
        raise AssertionError("the preempting trace preempted nothing")
    graphs_vs_eager(torch, "serve preempt", *runs, cfg.dtype)
    sampler_cost(torch, 2 * eng_kw["max_seqs"], cfg.vocab_size)
    return launches, dict(steps=steps, wall_s=wall, new_tokens=toks,
                          prompt_tokens=prompt_toks, **walls)


def phase_engine_diff(torch, arch, seed, tag, layers=None, bf16_kernels=None):
    """`arch` at full width (cut to `layers`, else full depth), fp32: 3
    greedy requests of 8 new tokens on the card and on the CPU, stepped in
    lockstep: identical tokens, logits within DIFF_LOGIT_ATOL.  With
    `bf16_kernels` (kernel module, tensor-core kernel name), then the bf16
    leg (`engine_bf16_leg`) on the same prompts."""
    from repro_torch import weights
    from repro_torch.configs import ARCHS
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request

    cfg = ARCHS[arch].replace(dtype="float32")
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    eng_kw = dict(max_seqs=4, num_pages=64, max_model_len=256, seed=SEED,
                  debug_logits=True)
    g = torch.Generator(device="cpu").manual_seed(seed)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()
               for n in (37, 70, 101)]
    engines, reqs = [], []
    for dev in (DEVICE, "cpu"):
        eng = Engine(cfg, weights.init_random(cfg, SEED, device=dev),
                     device=dev, **eng_kw)
        rs = [Request(prompt=list(p), max_new_tokens=8) for p in prompts]
        for r in rs:
            eng.add_request(r)
        engines.append(eng)
        reqs.append(rs)
    worst, steps = 0.0, 0
    while engines[0].sched.has_work:
        stats = [e.step() for e in engines]
        steps += 1
        if stats[0]["sampled_tokens"] != stats[1]["sampled_tokens"]:
            raise AssertionError(f"step {steps}: engines diverged")
        if steps == 1:  # the prefill of every prompt: the bf16 leg's ruler
            cpu_fp32_prefill = prefill_logits(engines[1], len(prompts))
        a = engines[0].last_step_logits.cpu()
        worst = max(worst, float((a - engines[1].last_step_logits).abs()
                                 .max()))
    gpu_out = [r.output for r in reqs[0]]
    cpu_out = [r.output for r in reqs[1]]
    log(f"{tag} {arch} {cfg.num_layers} layers fp32, {len(prompts)} requests "
        f"x 8 greedy tokens, {steps} steps: max_abs_logit_diff {worst:.3e} "
        f"(bound {DIFF_LOGIT_ATOL:g})  tokens_identical {gpu_out == cpu_out}")
    if gpu_out != cpu_out:
        raise AssertionError(f"greedy tokens differ:\n cuda {gpu_out}\n "
                             f"cpu  {cpu_out}")
    if engines[1].sched.has_work:
        raise AssertionError("cpu engine did not finish in lockstep")
    if not worst <= DIFF_LOGIT_ATOL:
        raise AssertionError(f"logit difference {worst} > {DIFF_LOGIT_ATOL}")
    if bf16_kernels is not None:
        engine_bf16_leg(torch, cfg, prompts, cpu_fp32_prefill, tag,
                        eng_kw, *bf16_kernels)
    return worst


def prefill_logits(eng, n):
    """The last-token logits of a first step that prefilled n prompts:
    the packed step's rows follow its static decode region of max_seqs
    rows; the padded step's prefill rows come first."""
    first = eng.max_seqs if eng._packed else 0
    return eng.last_step_logits[first:first + n]


def engine_bf16_leg(torch, cfg32, prompts, cpu_fp32, tag, eng_kw, kernels,
                    mma_name):
    """One prefill of `prompts` with the model in bf16 on the card (the
    tensor-core kernels) and on the CPU (plain versions), same seed: the
    max abs gap of the prefill's last-token logits within BF16_GAP_FACTOR
    x the gap between the CPU's own bf16 and fp32 (`cpu_fp32`) logits;
    the argmax agreement is logged.  `kernels.KERNEL_LAUNCHES[mma_name]`
    must count the card's launches.  The packed step (smollm) runs the
    leg through its CUDA graph: the same prompts are served once before
    (one new token each, which captures the key), so the leg's prefill
    replays the graph."""
    from repro_torch import weights
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request

    cfg = cfg32.replace(dtype="bfloat16")
    n = len(prompts)
    logits = []
    for dev in (DEVICE, "cpu"):
        eng = Engine(cfg, weights.init_random(cfg, SEED, device=dev),
                     device=dev, **eng_kw)
        graphed = eng._packed and eng._graphs
        if graphed:
            eng.generate([Request(prompt=list(p), max_new_tokens=1)
                          for p in prompts])
        replays = eng.graph_stats["replays"]
        for p in prompts:
            eng.add_request(Request(prompt=list(p), max_new_tokens=8))
        kernels.reset_launches()
        stats = eng.step()
        if stats["prefill"] != n or stats["decode"]:
            raise AssertionError(f"{tag} bf16: the first step was not one "
                                 f"prefill of {n} prompts: {stats}")
        if graphed and eng.graph_stats["replays"] != replays + 1:
            raise AssertionError(f"{tag} bf16: the prefill did not replay "
                                 f"a graph: {eng.graph_stats}")
        logits.append(prefill_logits(eng, n).float().cpu())
        if dev == DEVICE:
            torch.cuda.synchronize()
            mma_launches = kernels.KERNEL_LAUNCHES[mma_name]
            via = "graph replay" if graphed else "eager step"
    card, cpu = logits
    gap = float((card - cpu).abs().max())
    own = float((cpu - cpu_fp32.float()).abs().max())
    agree = int((card.argmax(-1) == cpu.argmax(-1)).sum())
    agree32 = int((cpu.argmax(-1) == cpu_fp32.argmax(-1)).sum())
    log(f"{tag} bf16 {cfg.name} {cfg.num_layers} layers, prefill of {n} "
        f"prompts: max_abs_logit_gap card-vs-cpu {gap:.3e}  cpu bf16-vs-fp32 "
        f"{own:.3e}  bound {BF16_GAP_FACTOR:g} x {own:.3e}  argmax agree "
        f"card-vs-cpu {agree}/{n}, cpu bf16-vs-fp32 {agree32}/{n}  "
        f"{mma_name} launches {mma_launches} (card: {via})")
    if not mma_launches:
        raise AssertionError(f"{tag} bf16: {mma_name} never launched")
    if not gap <= BF16_GAP_FACTOR * own:
        raise AssertionError(f"{tag} bf16: logit gap {gap} > "
                             f"{BF16_GAP_FACTOR} x {own}")


# ---------------------------------------------------------------------------
# the training path: flash attention and the trainer
# ---------------------------------------------------------------------------


def flash_inputs(torch, case, seed=3):
    """Packed kernel inputs (q [B*Hkv, nq, block_q*G, D], k / v
    [B*Hkv, Skv, D]) and their keyword arguments, on DEVICE."""
    from repro_torch.kernels.flash_attention import ops as fops

    b, sq, skv, hq, hkv, d, causal, off, dtype_name = case
    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((b, sq, hq, d), generator=g).to(dtype)
    k = torch.randn((b, skv, hkv, d), generator=g).to(dtype)
    v = torch.randn((b, skv, hkv, d), generator=g).to(dtype)
    group = hq // hkv
    bq = fops.pick_block_q(sq, group)
    qp = fops.pack_q(q, hkv).reshape(b * hkv, sq // bq, bq * group, d)
    kp, vp = (x.permute(0, 2, 1, 3).reshape(b * hkv, skv, d) for x in (k, v))
    args = tuple(x.contiguous().to(DEVICE) for x in (qp, kp, vp))
    kw = dict(block_q=bq, group=group, scale=d ** -0.5, causal=causal,
              q_offset=off)
    return args, kw, (q, k, v)


def phase_flash_check(torch, FK):
    from repro_torch.kernels.flash_attention import ops as fops

    worst = 0.0
    for case in FLASH_CASES:
        dtype_name = case[-1]
        args, kw, _ = flash_inputs(torch, case)
        o, lse = FK.flash_attention_fwd(*args, **kw)
        want_o, want_lse = FK.flash_attention_fwd_plain(*args, **kw)
        torch.cuda.synchronize()
        err_o = float((o.float() - want_o.float()).abs().max())
        err_l = float((lse - want_lse).abs().max())
        err = max(err_o, err_l)
        ok = err <= ATOL[dtype_name]
        log(f"flash check B {case[0]} Sq {case[1]} Skv {case[2]} Hq {case[3]}"
            f" Hkv {case[4]} D {case[5]} causal {case[6]} q_offset {case[7]}"
            f" {dtype_name}: o {err_o:.3e} lse {err_l:.3e} atol "
            f"{ATOL[dtype_name]:g}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash kernel disagrees with its plain "
                                 f"version at {case}")
        worst = max(worst, err)
    # gradient: autograd through the kernel on the card vs the plain
    # version on the CPU, same inputs, fp32
    *_, causal, off, _ = FLASH_GRAD_CASE
    _, _, inputs = flash_inputs(torch, FLASH_GRAD_CASE, seed=4)
    w = torch.randn(inputs[0].shape,
                    generator=torch.Generator(device="cpu").manual_seed(5))
    grads = []
    for dev in (DEVICE, "cpu"):
        xs = [x.to(dev).requires_grad_(True) for x in inputs]
        out = fops.flash_attention(*xs, causal=causal, q_offset=off)
        torch.sum(out * w.to(dev)).backward()
        grads.append([x.grad.cpu() for x in xs])
    gerr = max(float((a - b).abs().max()) for a, b in zip(*grads))
    log(f"flash grad  {FLASH_GRAD_CASE[:8]} fp32 card vs cpu: max_abs_err "
        f"{gerr:.3e} atol 1e-4  {'ok' if gerr <= 1e-4 else 'FAIL'}")
    if not gerr <= 1e-4:
        raise AssertionError("flash attention gradient: card vs CPU differ")
    return worst


def flash_bound(case):
    """(bound_ms, bound_by): causal FLOPs 4*B*Hq*D*S(S+1)/2 at the bf16
    peak vs q, k, v, o and the fp32 lse moved once at the HBM rate."""
    b, sq, skv, hq, hkv, d, causal, _, dtype_name = case
    e = 2 if dtype_name == "bfloat16" else 4
    pairs = sq * (sq + 1) // 2 if causal else sq * skv
    flops = 4 * b * hq * d * pairs
    nbytes = (2 * b * sq * hq * d + 2 * b * skv * hkv * d) * e + 4 * b * sq * hq
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_flash_time(torch, FK, iters=20):
    F = torch.nn.functional
    case = FLASH_TRAIN_CASE
    args, kw, (q, k, v) = flash_inputs(torch, case)
    qt, kt, vt = (x.transpose(1, 2).contiguous().to(DEVICE)
                  for x in (q, k, v))
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    ms = time_ms(torch, lambda: FK.flash_attention_fwd(*args, **kw), iters,
                 flush)
    plain_ms = time_ms(torch, lambda: FK.flash_attention_fwd_plain(*args,
                                                                   **kw),
                       3, flush)
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), iters, flush)
    bound_ms, bound_by = flash_bound(case)
    log(f"time  {FLASH:24s} {case[-1]} B {case[0]} S {case[1]} kernel_ms "
        f"{ms:.4f}  plain_ms {plain_ms:.4f}  library_ms {lib_ms:.4f}  "
        f"bound_ms {bound_ms:.5f} ({bound_by})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def markov_batches(torch, cfg, n, batch_size, seq_len, device):
    from repro_torch.training.data import DataState, MarkovDataset

    ds = MarkovDataset(cfg.vocab_size, seed=1)
    dstate, out = DataState(seed=1), []
    for _ in range(n):
        b, dstate = ds.batch(dstate, batch_size=batch_size, seq_len=seq_len)
        out.append({k: torch.from_numpy(v).to(device) for k, v in b.items()})
    return out


def phase_train(torch, K, FK):
    import math

    from repro_torch import weights
    from repro_torch.configs import ARCHS
    from repro_torch.training.trainer import make_train_state, train_step

    cfg = ARCHS[ARCH]
    if (cfg.num_q_heads, cfg.num_kv_heads, cfg.resolved_head_dim) \
            != FLASH_TRAIN_CASE[3:6]:
        raise AssertionError("FLASH_TRAIN_CASE is not the train phase's "
                             "attention shape")
    t0 = time.perf_counter()
    model = weights.init_random(cfg, SEED, device=DEVICE)
    state = make_train_state(model)
    steps = 1 + TRAIN_STEPS
    batches = markov_batches(torch, cfg, steps, TRAIN_BATCH, TRAIN_SEQ,
                             DEVICE)
    before = [p.detach().clone() for p in model.parameters()]
    log(f"train {ARCH}: {cfg.num_layers} layers d_model {cfg.d_model} "
        f"{cfg.dtype}, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}; set-up "
        f"{time.perf_counter() - t0:.1f}s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    FK.reset_launches()
    losses, gnorms, times = [], [], []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        state, m = train_step(model, state, batch, **TRAIN_KW)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        log(f"train step {i}{' (warm-up)' if i == 0 else ''}: loss "
            f"{losses[-1]:.4f} grad_norm {gnorms[-1]:.4f} lr "
            f"{float(m['lr']):.2e} {times[-1] * 1e3:.1f} ms")
    launches = FK.LAUNCHES[FLASH]
    paged = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    timed = times[1:]
    tok_s = TRAIN_BATCH * TRAIN_SEQ * len(timed) / sum(timed)
    log(f"train {len(timed)} timed steps: mean_step_ms "
        f"{sum(timed) / len(timed) * 1e3:.1f}  tokens_per_s {tok_s:.1f}  "
        f"max_memory_allocated_gib {peak / 2**30:.2f}  flash launches "
        f"{launches}  paged launches {paged}")
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"non-finite loss or grad norm: {losses} "
                             f"{gnorms}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f"step 0 loss {losses[0]} is not within 1.0 of "
                             f"ln V = {math.log(cfg.vocab_size):.2f}")
    # every matrix changes; bf16 norm scales near 1 may round back (the
    # reference keeps no fp32 master copy either)
    stuck = [n for (n, p), b in zip(model.named_parameters(), before)
             if p.ndim == 2 and torch.equal(p.detach(), b)]
    if stuck:
        raise AssertionError(f"parameters did not change: {stuck[:4]}")
    want = 2 * cfg.num_layers * steps  # each block's forward + its remat
    if launches != want:
        raise AssertionError(f"flash kernel launched {launches} times, "
                             f"expected {want}")
    if any(paged.values()):
        raise AssertionError(f"training launched serving kernels: {paged}")
    return launches


def phase_train_diff(torch):
    from repro_torch import weights
    from repro_torch.configs import ARCHS
    from repro_torch.training.trainer import make_train_state, train_step

    cfg = ARCHS[ARCH].replace(dtype="float32")
    runs = []
    for dev in (DEVICE, "cpu"):
        model = weights.init_random(cfg, SEED, device=dev)
        state = make_train_state(model)
        out = []
        for batch in markov_batches(torch, cfg, TDIFF_STEPS, TDIFF_BATCH,
                                    TDIFF_SEQ, dev):
            state, m = train_step(model, state, batch, **TRAIN_KW)
            out.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append(out)
        del model, state
    worst_l = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(*runs))
    worst_g = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(*runs))
    log(f"tdiff fp32 {TDIFF_STEPS} steps batch {TDIFF_BATCH} x seq "
        f"{TDIFF_SEQ}: card {runs[0]} cpu {runs[1]}; loss rel "
        f"{worst_l:.3e} (bound {TDIFF_LOSS_RTOL:g}), grad_norm rel "
        f"{worst_g:.3e} (bound {TDIFF_GNORM_RTOL:g})")
    if not (worst_l <= TDIFF_LOSS_RTOL and worst_g <= TDIFF_GNORM_RTOL):
        raise AssertionError("training on the card and on the CPU differ")


# ---------------------------------------------------------------------------
# the hybrid path: the Mamba2 SSD kernel and zamba2 through the padded step
# ---------------------------------------------------------------------------


def ssd_inputs(torch, case, dtype_name, seed=6, large_state=False):
    """Kernel inputs (x, dt, b, c, a_cum, s0) on DEVICE, drawn like
    tests/test_kernels_mamba2.py's, with a nonzero initial state (~100
    under x of ~0.01 if large_state) and a_cum from the port's own chunk
    cumsum."""
    from repro_torch.kernels.mamba2 import ops as sops

    bsz, l, h, p, n, grp, chunk = case
    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cpu").manual_seed(seed)
    x_scale, s_scale = (0.01, 100.0) if large_state else (1.0, 1.0)
    x = (x_scale * torch.randn((bsz, l, h, p), generator=g)).to(dtype)
    dt = torch.randn((bsz, l, h), generator=g).abs() * 0.5 + 0.01
    a = -torch.randn((h,), generator=g).abs() - 0.1
    bm = torch.randn((bsz, l, grp, n), generator=g).to(dtype)
    cm = torch.randn((bsz, l, grp, n), generator=g).to(dtype)
    s0 = s_scale * torch.randn((bsz, h, n, p), generator=g)
    a_cum = sops.chunk_cumsum(
        (dt * a).reshape(bsz, l // chunk, chunk, h)).reshape(bsz, l, h)
    return tuple(t.contiguous().to(DEVICE) for t in (x, dt, bm, cm, a_cum, s0))


def ssd_err(torch, got, want, dtype_name):
    """(error, bound, max abs error) over y and the final state: the error
    is fp32's relative to max |y| (the state's to max |state|), bf16's
    absolute."""
    errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
    if dtype_name == "float32":
        return max(e / max(1.0, float(b.abs().max()))
                   for e, b in zip(errs, want)), SSD_FP32_RTOL, max(errs)
    return max(errs), SSD_BF16_ATOL, max(errs)


def phase_ssd_check(torch, SK):
    worst = 0.0
    cases = [(c, False) for c in SSD_CASES] + [(SSD_LARGE_STATE_CASE, True)]
    for case, large in cases:
        for dtype_name in ("float32", "bfloat16"):
            args = ssd_inputs(torch, case, dtype_name, large_state=large)
            got = SK.ssd_chunked_fwd(*args, chunk=case[-1])
            want = SK.ssd_chunked_fwd_plain(*args, chunk=case[-1])
            torch.cuda.synchronize()
            err, bound, abs_err = ssd_err(torch, got, want, dtype_name)
            ok = err <= bound
            log(f"ssd check B {case[0]} L {case[1]} H {case[2]} P {case[3]} "
                f"N {case[4]} G {case[5]} chunk {case[6]}"
                f"{' large state' if large else ''} {dtype_name}: "
                f"err {err:.3e} bound {bound:g} "
                f"({'x max|y|' if dtype_name == 'float32' else 'abs'})  "
                f"max|y| {float(want[0].abs().max()):.1f}  "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"SSD kernel disagrees with its plain "
                                     f"version at {case} {dtype_name}")
            worst = max(worst, abs_err)
    return worst


def ssd_bound(case, dtype_name):
    """(bound_ms, bound_by): FLOPs B*H*nc*(2Q^2(N+P) + 4QNP) at the peak
    for the inputs' type vs the bytes of every input read once (x, B, C in
    the inputs' type; dt, a_cum, s0 fp32) and y (fp32) plus the final
    state written once."""
    bsz, l, h, p, n, grp, q = case
    e = 2 if dtype_name == "bfloat16" else 4
    flops = bsz * h * (l // q) * (2 * q * q * (n + p) + 4 * q * n * p)
    nbytes = (bsz * l * h * p * e + 2 * bsz * l * grp * n * e
              + 2 * bsz * l * h * 4 + 2 * bsz * h * n * p * 4
              + bsz * l * h * p * 4)
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_ssd_time(torch, SK, dtype_name="bfloat16", iters=20):
    case = SSD_SERVE_CASE
    args = ssd_inputs(torch, case, dtype_name)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    ms = time_ms(torch, lambda: SK.ssd_chunked_fwd(*args, chunk=case[-1]),
                 iters, flush)
    plain_ms = time_ms(torch, lambda: SK.ssd_chunked_fwd_plain(
        *args, chunk=case[-1]), 3, flush)
    bound_ms, bound_by = ssd_bound(case, dtype_name)
    log(f"time  {SSD:24s} {dtype_name} B {case[0]} L {case[1]} H {case[2]} "
        f"P {case[3]} N {case[4]} chunk {case[6]} kernel_ms {ms:.4f}  "
        f"plain_ms {plain_ms:.4f}  library_ms null (no single PyTorch call "
        f"computes the SSD)  bound_ms {bound_ms:.5f} ({bound_by})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by)


def phase_hybrid_serve(torch, K, FK, SK):
    from repro_torch import weights
    from repro_torch.configs import ARCHS
    from repro_torch.models.model import hybrid_layout
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request, State

    cfg = ARCHS[HYBRID_ARCH]
    n_mamba, n_attn, _ = hybrid_layout(cfg)
    t0 = time.perf_counter()
    model = weights.init_random(cfg, SEED, device=DEVICE)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"hserve {HYBRID_ARCH}: {n_mamba} Mamba2 + {n_attn} shared-attention "
        f"layers, d_model {cfg.d_model}, heads {cfg.num_q_heads}/"
        f"{cfg.num_kv_heads}, ssm H {cfg.ssm.num_heads} P {cfg.ssm.head_dim} "
        f"N {cfg.ssm.state_dim}, vocab {cfg.vocab_size}, {cfg.dtype}, "
        f"{n_params / 1e9:.3f} B parameters; weights in "
        f"{time.perf_counter() - t0:.1f}s")
    eng_kw = dict(max_seqs=HYBRID_REQUESTS, num_pages=1024,
                  max_model_len=2048, seed=SEED, debug_logits=True,
                  device=DEVICE)
    g = torch.Generator(device="cpu").manual_seed(SEED + 2)

    def prompts(n, lo, hi):
        lens = torch.randint(lo, hi + 1, (n,), generator=g).tolist()
        lens[0] = hi  # the longest sets the prefill's padded length
        return [torch.randint(1, cfg.vocab_size, (n_,), generator=g).tolist()
                for n_ in lens]

    warm = Engine(cfg, model, **eng_kw)
    warm.generate([Request(prompt=p, max_new_tokens=4)
                   for p in prompts(2, 40, 200)])
    del warm
    torch.cuda.synchronize()

    served = prompts(HYBRID_REQUESTS, 128, SSD_SERVE_CASE[1])

    def requests():
        return [Request(prompt=list(p), max_new_tokens=HYBRID_NEW_TOKENS)
                for p in served]

    eng = Engine(cfg, model, **eng_kw)
    torch.cuda.reset_peak_memory_stats()
    run = serve_run(torch, eng, requests(), "hserve")
    reqs, steps, wall = run["reqs"], len(run["stats"]), run["wall"]
    picks = {(phase, d["variant"], d["tile"], d["num_segments"], d["block_q"])
             for st in run["stats"] for phase, d in st["dispatch"].items()}
    launches = dict(K.LAUNCHES) | dict(FK.LAUNCHES) | dict(SK.LAUNCHES)
    calls = dict(eng.device_calls)
    log(f"hserve launches {launches}  device_calls {calls}  dispatch "
        f"{dict(eng.dispatch_counts)}  configs {sorted(picks)}")
    if not all(r.state is State.FINISHED
               and len(r.output) == HYBRID_NEW_TOKENS for r in reqs):
        raise AssertionError("not every request finished")
    if eng._packed or "unified" in calls:
        raise AssertionError("the hybrid did not take the padded step")
    n_pref, n_dec = calls.get("prefill", 0), calls.get("decode", 0)
    prefill_rows = eng.launched_token_slots - HYBRID_REQUESTS * n_dec
    if n_pref != 1 or prefill_rows != HYBRID_REQUESTS * SSD_SERVE_CASE[1]:
        raise AssertionError(f"expected one prefill of {HYBRID_REQUESTS} x "
                             f"{SSD_SERVE_CASE[1]} tokens (SSD_SERVE_CASE), "
                             f"got {n_pref} prefill calls of {prefill_rows} "
                             f"token rows")
    gqa = eng.dispatch_counts[("decode", "gqa")]
    seg = eng.dispatch_counts[("decode", "segmented")]
    want = {SSD: n_mamba * n_pref,
            "paged_prefill_qblock": n_attn * n_pref,
            "paged_decode": n_attn * gqa,
            "paged_decode_segmented": n_attn * seg,
            "segment_reduce": n_attn * seg,
            FLASH: 0}
    if gqa + seg != n_dec or launches != want or not launches[SSD]:
        raise AssertionError(f"launch counts {launches} != {want} "
                             f"({n_pref} prefill, {n_dec} decode calls)")
    check_paged_routes(K, launches, "hserve", cfg.dtype)
    # bf16 serving: every SSD launch was the tensor-core kernel
    routes = {"ssd_mma_kernel": want[SSD], "ssd_fwd_kernel": 0}
    log(f"hserve ssd kernels {SK.KERNEL_LAUNCHES}")
    if SK.KERNEL_LAUNCHES != routes:
        raise AssertionError(f"SSD kernels {SK.KERNEL_LAUNCHES} != {routes}")
    # the engine picked the configs phase 3 checked at these shapes (tile
    # None: the page's default tile)
    shp = PAGED_SHAPES[HYBRID_ARCH]
    checked = {("prefill", "gqa", None, 8, PAGED_BLOCK_Q),
               ("decode", "segmented", None, shp["num_segments"],
                PAGED_BLOCK_Q)}
    if picks != checked or shp["stride"] != SSD_SERVE_CASE[1]:
        raise AssertionError(f"the engine's attention configs {picks} are "
                             f"not those phase 3 checked: {checked}, {shp}")
    toks = sum(len(r.output) for r in reqs)
    prompt_toks = sum(r.num_prompt_tokens for r in reqs)
    log(f"hserve steps {steps}  prompt_tokens {prompt_toks}  new_tokens "
        f"{toks}  wall_s {wall:.3f}  new_tok_per_s {toks / wall:.1f}  "
        f"total_tok_per_s {(toks + prompt_toks) / wall:.1f}  "
        f"max_memory_allocated_gib "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    del eng
    eager = serve_run(torch, Engine(cfg, model, cuda_graphs=False, **eng_kw),
                      requests(), "hserve eager")
    graphs_vs_eager(torch, "hserve", run, eager, cfg.dtype)
    return launches


# ---------------------------------------------------------------------------
# the ssm path: the mLSTM kernel and xlstm through the padded step
# ---------------------------------------------------------------------------


def mlstm_inputs(torch, case, dtype_name, seed=7):
    """Kernel inputs (q, k, v, ig, bcum, g, c0, n0, m0) on DEVICE: q, k, v
    and the gate preactivations drawn like tests/test_kernels_mlstm.py's,
    bcum and g from the port's own host layer."""
    from repro_torch.kernels._common import chunk_cumsum
    from repro_torch.kernels.mlstm import ops as mops

    bsz, l, h, p, chunk, gates, state = case
    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cpu").manual_seed(seed)
    qkv_scale = 0.01 if state == "large" else 1.0
    q, k, v = ((qkv_scale * torch.randn((bsz, l, h, p), generator=g)).to(dtype)
               for _ in range(3))
    ig = torch.randn((bsz, l, h), generator=g)
    fg = torch.randn((bsz, l, h), generator=g) + 2.0
    if gates == "extreme":  # test_extreme_gates_stable's
        ig, fg = ig * 30.0, fg - 20.0
    elif gates == "padded":  # the mLSTM block's state-neutral padding
        lens = torch.tensor(MLSTM_PAD_LENS)[:, None, None]
        valid = torch.arange(l)[None, :, None] < lens
        ig = torch.where(valid, ig, -30.0)
        fg = torch.where(valid, fg, 30.0)
    nc = l // chunk
    bcum = chunk_cumsum(torch.nn.functional.logsigmoid(fg).reshape(
        bsz, nc, chunk, h))
    gg = torch.cummax(ig.reshape(bsz, nc, chunk, h) - bcum, 2).values
    if state in ("nonzero", "large"):
        # "large": m0 ~30 keeps decay = 1 (m_in above every chunk's gate
        # max), so C and n stay ~100 through the chunks; q and n0 positive,
        # so no denominator q . n_in cancels towards 0
        s_scale, m_shift = (100.0, 30.0) if state == "large" else (0.1, 0.0)
        c0 = s_scale * torch.randn((bsz, h, p, p), generator=g)
        n0 = s_scale * torch.randn((bsz, h, p), generator=g)
        m0 = m_shift + torch.randn((bsz, h), generator=g)
        if state == "large":
            q, n0 = q.abs(), n0.abs()
    else:
        c0, n0, m0 = mops.zero_state(bsz, h, p, "cpu")
    return tuple(t.contiguous().to(DEVICE) for t in (
        q, k, v, ig, bcum.reshape(bsz, l, h), gg.reshape(bsz, l, h), c0, n0,
        m0))


def phase_mlstm_check(torch, MK):
    worst = 0.0
    for case in MLSTM_CASES:
        p, chunk = case[3], case[4]
        for dtype_name in ("float32", "bfloat16"):
            args = mlstm_inputs(torch, case, dtype_name)
            got = MK.mlstm_chunked_fwd(*args, chunk=chunk, scale=p ** -0.5)
            want = MK.mlstm_chunked_fwd_plain(*args, chunk=chunk,
                                              scale=p ** -0.5)
            torch.cuda.synchronize()
            report, ok = [], True
            for name, a, b in zip(("h", "C", "n", "m"), got, want):
                if not bool(torch.isfinite(a.float()).all()):
                    raise AssertionError(f"mLSTM kernel: non-finite {name} "
                                         f"at {case} {dtype_name}")
                err = float((a.float() - b.float()).abs().max())
                scale_ = max(1.0, float(b.float().abs().max()))
                rtol = (MLSTM_BF16_H_RTOL if name == "h"
                        and dtype_name == "bfloat16" else MLSTM_FP32_RTOL)
                ok = ok and err <= rtol * scale_
                report.append(f"{name} {err:.2e} (bound {rtol * scale_:.2e})")
                worst = max(worst, err)
            log(f"mlstm check B {case[0]} L {case[1]} H {case[2]} P {p} "
                f"chunk {chunk} gates {case[5]} state {case[6]} "
                f"{dtype_name}: {'  '.join(report)}  "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"mLSTM kernel disagrees with its plain "
                                     f"version at {case} {dtype_name}")
    return worst


def mlstm_bound(case, dtype_name):
    """(bound_ms, bound_by): FLOPs B*H*nc*(6Q^2P + 4QP^2) (q k^T, S v and
    the decayed sum of k within the chunk; q C and the k^T v update) at
    the peak for the inputs' type vs the bytes of q, k, v (the inputs'
    type), the fp32 gates ig, bcum, g and the initial state read once, h
    (the inputs' type) and the final state written once."""
    bsz, l, h, p, q = case[:5]
    e = 2 if dtype_name == "bfloat16" else 4
    flops = bsz * h * (l // q) * (6 * q * q * p + 4 * q * p * p)
    state = bsz * h * (p * p + p + 1) * 4
    nbytes = 4 * bsz * l * h * p * e + 3 * bsz * l * h * 4 + 2 * state
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_mlstm_time(torch, MK, dtype_name="bfloat16", iters=20):
    case = MLSTM_SERVE_CASE
    args = mlstm_inputs(torch, case, dtype_name)
    kw = dict(chunk=case[4], scale=case[3] ** -0.5)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    ms = time_ms(torch, lambda: MK.mlstm_chunked_fwd(*args, **kw), iters,
                 flush)
    plain_ms = time_ms(torch, lambda: MK.mlstm_chunked_fwd_plain(*args, **kw),
                       3, flush)
    bound_ms, bound_by = mlstm_bound(case, dtype_name)
    log(f"time  {MLSTM:24s} {dtype_name} B {case[0]} L {case[1]} H {case[2]} "
        f"P {case[3]} chunk {case[4]} kernel_ms {ms:.4f}  plain_ms "
        f"{plain_ms:.4f}  library_ms null (no single PyTorch call computes "
        f"the chunked mLSTM)  bound_ms {bound_ms:.5f} ({bound_by})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by)


def phase_xlstm_serve(torch, kernel_modules):
    from repro_torch import weights
    from repro_torch.configs import ARCHS
    from repro_torch.models.model import xlstm_layout
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request, State

    cfg = ARCHS[XLSTM_ARCH]
    n_m, n_s, _ = xlstm_layout(cfg)
    t0 = time.perf_counter()
    model = weights.init_random(cfg, SEED, device=DEVICE)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"xserve {XLSTM_ARCH}: {n_m} mLSTM + {n_s} sLSTM layers, d_model "
        f"{cfg.d_model}, mLSTM H {cfg.ssm.num_heads} P {cfg.ssm.head_dim} "
        f"chunk {cfg.ssm.chunk}, vocab {cfg.vocab_size}, {cfg.dtype}, "
        f"{n_params / 1e9:.3f} B parameters; weights in "
        f"{time.perf_counter() - t0:.1f}s")
    eng_kw = dict(max_seqs=XLSTM_REQUESTS, num_pages=1024,
                  max_model_len=2048, seed=SEED, debug_logits=True,
                  device=DEVICE)
    g = torch.Generator(device="cpu").manual_seed(SEED + 4)

    def prompts(n, lo, hi):
        lens = torch.randint(lo, hi + 1, (n,), generator=g).tolist()
        lens[0] = hi  # the longest sets the prefill's padded length
        return [torch.randint(1, cfg.vocab_size, (n_,), generator=g).tolist()
                for n_ in lens]

    warm = Engine(cfg, model, **eng_kw)
    warm.generate([Request(prompt=p, max_new_tokens=4)
                   for p in prompts(2, 40, 200)])
    del warm
    torch.cuda.synchronize()

    served = prompts(XLSTM_REQUESTS, 128, MLSTM_SERVE_CASE[1])

    def requests():
        return [Request(prompt=list(p), max_new_tokens=XLSTM_NEW_TOKENS)
                for p in served]

    eng = Engine(cfg, model, **eng_kw)
    torch.cuda.reset_peak_memory_stats()
    run = serve_run(torch, eng, requests(), "xserve")
    reqs, steps, wall = run["reqs"], len(run["stats"]), run["wall"]
    prefill_s = sum(w for w, st in zip(run["step_walls"], run["stats"])
                    if st["prefill"])
    launches = {}
    for kernels in kernel_modules:
        launches.update(kernels.LAUNCHES)
    calls = dict(eng.device_calls)
    log(f"xserve launches {launches}  device_calls {calls}  dispatch "
        f"{dict(eng.dispatch_counts)}")
    if not all(r.state is State.FINISHED
               and len(r.output) == XLSTM_NEW_TOKENS for r in reqs):
        raise AssertionError("not every request finished")
    if eng._packed or "unified" in calls or "attn" in eng.cache:
        raise AssertionError("xlstm did not take the padded step")
    n_pref, n_dec = calls.get("prefill", 0), calls.get("decode", 0)
    prefill_rows = eng.launched_token_slots - XLSTM_REQUESTS * n_dec
    if n_pref != 1 or prefill_rows != XLSTM_REQUESTS * MLSTM_SERVE_CASE[1]:
        raise AssertionError(f"expected one prefill of {XLSTM_REQUESTS} x "
                             f"{MLSTM_SERVE_CASE[1]} tokens "
                             f"(MLSTM_SERVE_CASE), got {n_pref} prefill calls "
                             f"of {prefill_rows} token rows")
    want = {name: 0 for name in launches}
    want[MLSTM] = n_m * n_pref
    if launches != want or not launches[MLSTM] or eng.dispatch_counts:
        raise AssertionError(f"launch counts {launches} != {want} "
                             f"({n_pref} prefill, {n_dec} decode calls), "
                             f"dispatch {dict(eng.dispatch_counts)}")
    # bf16 serving: every mLSTM launch was the tensor-core kernel
    MK = next(m for m in kernel_modules if MLSTM in m.LAUNCHES)
    routes = {"mlstm_mma_kernel": want[MLSTM], "mlstm_fwd_kernel": 0}
    log(f"xserve mlstm kernels {MK.KERNEL_LAUNCHES}")
    if MK.KERNEL_LAUNCHES != routes:
        raise AssertionError(f"mLSTM kernels {MK.KERNEL_LAUNCHES} != "
                             f"{routes}")
    toks = sum(len(r.output) for r in reqs)
    prompt_toks = sum(r.num_prompt_tokens for r in reqs)
    log(f"xserve steps {steps}  prompt_tokens {prompt_toks}  new_tokens "
        f"{toks}  wall_s {wall:.3f}  prefill_s {prefill_s:.3f}  "
        f"new_tok_per_s {toks / wall:.1f}  total_tok_per_s "
        f"{(toks + prompt_toks) / wall:.1f}  max_memory_allocated_gib "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    del eng
    eager = serve_run(torch, Engine(cfg, model, cuda_graphs=False, **eng_kw),
                      requests(), "xserve eager")
    graphs_vs_eager(torch, "xserve", run, eager, cfg.dtype)
    return launches


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc" / "mamba2_ssd.cu").exists():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    t_lap = [t_start]

    def lap(phase: str) -> None:
        """Log the seconds since the previous lap: one phase's duration."""
        now = time.perf_counter()
        log(f"phase {phase} {now - t_lap[0]:.1f}s")
        t_lap[0] = now

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"device {kind}  count {torch.cuda.device_count()}  "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"nvidia-smi {smi}")
    lap("1 device")

    # 2. build: one nvcc per source, all started together
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.mamba2 import kernel as SK
    from repro_torch.kernels.mlstm import kernel as MK
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention import ops as tops

    t0 = time.perf_counter()
    libraries = (K.library, FK.library, SK.library, MK.library)
    with ThreadPoolExecutor(max_workers=len(libraries)) as pool:
        for f in [pool.submit(lib) for lib in libraries]:
            f.result()
    for name in sorted(_build.BUILD_SECONDS):
        log(f"build {name}.cu -> {_build.library_path(name)} (nvcc "
            f"{_build.BUILD_SECONDS[name]:.1f}s)")
    log(f"build all in {time.perf_counter() - t0:.1f}s")
    lap("2 build")

    # 3. kernels against their plain versions
    errs = phase_check(torch, K, tops)
    lap("3 check")

    # 4. kernel times at the main path's shapes (bf16, the serving dtype)
    times = phase_time(torch, K, tops)
    lap("4 time")

    # 5. end to end through the port's serving path
    launches, serve = phase_serve(torch, K, FK)
    lap("5 serve")

    # 6. card (kernels, graphs) vs CPU (plain versions), fp32; then one
    # bf16 prefill through the graphed packed step
    phase_engine_diff(torch, ARCH, SEED + 1, "diff", None,
                      (K, "prefill_mma_kernel"))
    lap("6 diff")

    # 7. the flash kernel against its plain version; the gradient card vs CPU
    flash_err = phase_flash_check(torch, FK)
    lap("7 flash")

    # 8. the flash kernel's time at the training shape (bf16)
    flash_time = phase_flash_time(torch, FK)
    lap("8 ftime")

    # 9. end to end through the port's training path
    flash_launches = phase_train(torch, K, FK)
    lap("9 train")

    # 10. training on the card (kernel) vs the CPU (plain version), fp32
    phase_train_diff(torch)
    lap("10 tdiff")

    # 11. the SSD kernel against its plain version
    ssd_err_ = phase_ssd_check(torch, SK)
    lap("11 ssd")

    # 12. the SSD kernel's time at the hybrid serve shape (bf16)
    ssd_time = phase_ssd_time(torch, SK)
    lap("12 ssdtime")

    # 13. end to end through the padded step: zamba2 on the SSD and paged
    # kernels
    hybrid_launches = phase_hybrid_serve(torch, K, FK, SK)
    lap("13 hserve")

    # 14. the hybrid on the card vs the CPU, fp32; then one bf16 prefill
    phase_engine_diff(torch, HYBRID_ARCH, SEED + 3, "hdiff", HDIFF_LAYERS,
                      (SK, "ssd_mma_kernel"))
    lap("14 hdiff")

    # 15. the mLSTM kernel against its plain version
    mlstm_err = phase_mlstm_check(torch, MK)
    lap("15 mlstm")

    # 16. the mLSTM kernel's time at the xlstm serve shape (bf16)
    mlstm_time = phase_mlstm_time(torch, MK)
    lap("16 mltime")

    # 17. end to end through the padded step: xlstm on the mLSTM kernel
    xlstm_launches = phase_xlstm_serve(torch, (K, FK, SK, MK))
    lap("17 xserve")

    # 18. xlstm on the card vs the CPU, fp32; then one bf16 prefill
    phase_engine_diff(torch, XLSTM_ARCH, SEED + 5, "xdiff", XDIFF_LAYERS,
                      (MK, "mlstm_mma_kernel"))
    lap("18 xdiff")

    # the segment_reduce row is the folded launch that computes it on the
    # main path (its standalone kernel is checked and timed, never served)
    times["segment_reduce"] = times[MERGED]
    errs["segment_reduce"] = max(errs["segment_reduce"], errs[MERGED])
    kernels = [dict(name=name, route="cuda", source=KERNEL_SOURCE,
                    replaces=REPLACES[name], launches=launches[name],
                    max_abs_err=errs[name], **times[name])
               for name in REPLACES]
    kernels.append(dict(name=FLASH, route="cuda", source=FLASH_SOURCE,
                        replaces=FLASH_REPLACES, launches=flash_launches,
                        max_abs_err=flash_err, **flash_time))
    kernels.append(dict(name=SSD, route="cuda", source=SSD_SOURCE,
                        replaces=SSD_REPLACES,
                        launches=hybrid_launches[SSD],
                        max_abs_err=ssd_err_, **ssd_time))
    kernels.append(dict(name=MLSTM, route="cuda", source=MLSTM_SOURCE,
                        replaces=MLSTM_REPLACES,
                        launches=xlstm_launches[MLSTM],
                        max_abs_err=mlstm_err, **mlstm_time))
    log(f"total_s {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
