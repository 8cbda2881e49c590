"""The CUDA kernels (paged attention, flash attention, the Mamba2 SSD, the
chunked mLSTM, the grouped expert GEMM, MLA's latent decode, the layer
glue, the optimizer step) against their plain PyTorch versions on the
card, and the port's engines (packed
smollm and llama4-maverick, padded zamba2, xlstm and deepseek-v2), the
MoE layer and the flash attention gradient on the card against
themselves on the CPU.

Needs an NVIDIA GPU and nvcc: every test here is marked `cuda` and skips
on a host without CUDA.  Run on the card with

    python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

The engine's CUDA graphs (the packed step and the padded decode step,
captured at a key's first step and replayed after; the speculative verify
step; the two-dispatch step's packed launch) against the same engine with
`cuda_graphs=False`: the same tokens, bit-equal logits and KV pages, and
the same launch counts.  The unified op at the verify step's shapes.  The async loop (`submit()` + `run()`)
on the graphs against the synchronous graphed run: the same, and its
sampled ids leave the card through two pinned buffers in turn.

Imports neither JAX nor the JAX package.  Tolerances: fp32 atol 1e-4
with TF32 off (summation order), bf16 atol 2e-2 (an output ulp near 1 is
7.8e-3; p is rounded to bf16 before p.V on both sides).  In bf16 the
flash forward and the Q-Block prefill run on the tensor-core kernels
(head dim 64 or 128; another head dim raises), in fp32 on the scalar
ones; so do the SSD and the mLSTM (every shape; bf16 operands must be
16-byte aligned).  The SSD sums up
to 128 x 64 products of values as large as |y| in another order than the
plain version's matmuls: fp32 within 1e-5 x max |y| (TF32 off); bf16
within 2e-2 (the bf16 inputs are exact on both sides; the tensor-core
kernel's fp32 operands go in as bf16 hi + lo halves, ~2^-17 of a term).
The mLSTM divides sums of up to 64 + 512 products (another order than the
plain version's) by a denominator that can sit at its exp(-m) floor:
fp32 within 2e-5 x max |out|; with bf16 inputs the fp32 state within the
same and h, rounded to bf16 on both sides, within 8e-3 x max |h| (one
bf16 ulp is at most 2^-7 of the value).
"""
import numpy as np
import pytest
import torch

from repro_torch import weights
from repro_torch.configs import ARCHS, reduced
from repro_torch.core.paged.kv_cache import write_index
from repro_torch.kernels._common import (
    MMA_HEAD_DIMS, NEG_INF, LaunchLimitError, chunk_cumsum,
)
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.layer_glue import kernel as GL
from repro_torch.kernels.mamba2 import kernel as SK
from repro_torch.kernels.mamba2 import ops as sops
from repro_torch.kernels.mla_decode import kernel as AK
from repro_torch.kernels.mla_decode import ops as aops
from repro_torch.kernels.mlstm import kernel as MK
from repro_torch.kernels.mlstm import ops as mops
from repro_torch.kernels.moe import kernel as GK
from repro_torch.kernels.paged_attention import kernel as K
from repro_torch.kernels.paged_attention import ops
from repro_torch.models import layers as TL
from repro_torch.serving import cuda_graphs
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request

pytestmark = pytest.mark.cuda
ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, dtype, hkv, group, ps, ctx, d=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    s = len(ctx)
    np_ = -(-max(ctx + [1]) // ps) + 1
    p = s * np_ + 1
    q = torch.randn((s, hkv * group, d), generator=g).to(dtype)
    kp = torch.randn((hkv, p, ps, d), generator=g).to(dtype)
    vp = torch.randn((hkv, p, ps, d), generator=g).to(dtype)
    pt = (torch.randperm(p - 1, generator=g)[: s * np_].reshape(s, np_)
          + 1).to(torch.int32)
    ctx = torch.tensor(ctx, dtype=torch.int32)
    return [t.to(dev) for t in (q, kp, vp, pt, ctx)]


CASES = [  # hkv, group, page, tile, contexts, head dim
    (3, 3, 16, 16, [0, 1, 17, 300, 77], 64),
    (2, 1, 16, 8, [40, 0, 5], 64),
    (1, 4, 24, 24, [95, 24, 0, 1], 64),
    (2, 2, 24, 8, [13, 200], 64),
    # qwen2.5-3b's heads (group 8, D 128) and glm4-9b's (group 16: two
    # blocks of 8 rows over the same keys)
    (2, 8, 16, 16, [0, 1, 33, 300, 777], 128),
    (2, 16, 16, 16, [129, 0, 64, 1000], 128),
    # zamba2's decode: Hkv 32, group 1
    (32, 1, 16, 16, [1056, 129, 300, 0, 517], 64),
    # a 2048-token context: at 16 segments of 144 keys, 14 live, one partly
    # live, one dead; 1024 ends on a page, 1008 on a segment boundary
    (3, 3, 16, 16, [2048, 1024, 1008, 1000, 0], 64),
    # head dims whose rows are no power-of-two multiple of 16 bytes (lanes
    # masked), and the extremes: one lane a key (D 8), a warp a key (D 256)
    (2, 2, 24, 8, [13, 200, 48], 40),
    (1, 3, 16, 16, [5, 77, 0], 24),
    (2, 1, 16, 16, [70, 3, 0], 8),
    (1, 2, 16, 8, [100, 0, 31], 256),
    # 12 rows: a block of 8 and a block of 4 live rows out of 8
    (1, 12, 16, 8, [90, 0, 47], 64),
    # qwen2-vl-2b's heads: group 6, six live rows in a block of 8, D 128
    (2, 6, 16, 16, [0, 1, 33, 300, 777, 2048], 128),
]
# the unified op's prefill half takes head dims 64 and 128 in bf16 (the
# tensor-core kernel) and, in fp32, Q-blocks of 16 x group rows that fit
# the scalar kernel's shared memory (glm4's 256 rows at D 128 do not)
UNIFIED_CASES = [c for c in CASES if c[5] in MMA_HEAD_DIMS and c[1] <= 8]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_decode_kernels_match_plain(cuda, dtype, case):
    hkv, group, ps, tile, ctx, d = case
    q, kp, vp, pt, cl = _case(cuda, dtype, hkv, group, ps, ctx, d=d)
    s, hq, d = q.shape
    kt = kp.reshape(hkv, -1, ps // tile, tile, d)
    vt = vp.reshape(hkv, -1, ps // tile, tile, d)
    n0 = dict(K.LAUNCHES)
    for qq, cpk in ((q.reshape(s, hkv, group, d), 1),
                    (q.reshape(s, hq, 1, d), group)):
        got = K.paged_decode(qq, kt, vt, pt, cl, cells_per_kv=cpk, scale=0.125)
        want = K.paged_decode_plain(qq, kt, vt, pt, cl, cells_per_kv=cpk,
                                    scale=0.125)
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=ATOL[dtype], rtol=0)
        assert (got[cl == 0] == 0).all()
    num_tiles = pt.shape[1] * (ps // tile)
    for nseg in (1, 3, 16, num_tiles + 2):
        nseg = min(nseg, num_tiles)
        tps = -(-num_tiles // nseg)
        kw = dict(num_segments=nseg, tiles_per_segment=tps, scale=0.125)
        qg = q.reshape(s, hkv, group, d)
        parts = K.paged_decode_segmented(qg, kt, vt, pt, cl, **kw)
        ref = K.paged_decode_segmented_plain(qg, kt, vt, pt, cl, **kw)
        torch.testing.assert_close(parts[1], ref[1], atol=1e-4, rtol=0)
        torch.testing.assert_close(parts[2], ref[2], atol=0, rtol=1e-4)
        # the unnormalised accumulator grows with the context: compare acc / l
        norm = lambda o, l: o / torch.where(l == 0, 1.0, l)[..., None]  # noqa: E731
        torch.testing.assert_close(norm(parts[0], parts[2]),
                                   norm(ref[0], ref[2]), atol=ATOL[dtype],
                                   rtol=0)
        # a segment without live keys is exactly (acc 0, m NEG_INF, l 0):
        # segment_reduce's dead test relies on it
        start = torch.arange(nseg, device=cuda) * tps * tile
        dead = start[None, :] >= cl[:, None]  # [S, nseg]
        assert (parts[1].permute(0, 2, 1, 3)[dead] == NEG_INF).all()
        assert (parts[2].permute(0, 2, 1, 3)[dead] == 0).all()
        assert (parts[0].permute(0, 2, 1, 3, 4)[dead] == 0).all()
        got = K.segment_reduce(*parts, dtype)
        torch.testing.assert_close(
            got.float(), K.segment_reduce_plain(*parts, dtype).float(),
            atol=ATOL[dtype], rtol=0)
    assert K.LAUNCHES["paged_decode"] == n0["paged_decode"] + 2
    assert K.LAUNCHES["paged_decode_segmented"] == \
        n0["paged_decode_segmented"] + 4
    assert K.LAUNCHES["segment_reduce"] == n0["segment_reduce"] + 4


def _bits(x):
    """x's bits as integers: equal bits, not merely equal values."""
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_segmented_merged_kernel_matches_two_launches(cuda, dtype, case):
    """The serving path's C3 launch (partials and merge in one kernel)
    gives the bits of paged_decode_segmented + segment_reduce, is within
    ATOL of its plain version, and is one decode_stream_seg_merge_kernel
    launch."""
    hkv, group, ps, tile, ctx, d = case
    q, kp, vp, pt, cl = _case(cuda, dtype, hkv, group, ps, ctx, d=d)
    s = q.shape[0]
    kt = kp.reshape(hkv, -1, ps // tile, tile, d)
    vt = vp.reshape(hkv, -1, ps // tile, tile, d)
    qg = q.reshape(s, hkv, group, d)
    num_tiles = pt.shape[1] * (ps // tile)
    for nseg in (1, 3, 16, num_tiles + 2):
        nseg = min(nseg, num_tiles)
        kw = dict(num_segments=nseg, tiles_per_segment=-(-num_tiles // nseg),
                  scale=0.125)
        n0 = dict(K.KERNEL_LAUNCHES)
        got = K.paged_decode_segmented_merged(qg, kt, vt, pt, cl, **kw)
        assert K.KERNEL_LAUNCHES == n0 | {
            "decode_stream_seg_merge_kernel":
                n0["decode_stream_seg_merge_kernel"] + 1}
        pair = K.segment_reduce(*K.paged_decode_segmented(qg, kt, vt, pt, cl,
                                                          **kw), dtype)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == qg.shape
        assert torch.equal(_bits(got), _bits(pair))
        want = K.paged_decode_segmented_merged_plain(qg, kt, vt, pt, cl, **kw)
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=ATOL[dtype], rtol=0)
        assert (got[cl == 0] == 0).all()


def test_segmented_merged_counters_rearm(cuda):
    """The merged launch's arrival counters reset themselves: three
    launches in a row, one at a larger grid (more sequences: the buffer
    grows), then the first shape again all give the two-launch bits, and
    the counters are zero after each."""
    hkv, group, ps, tile = 3, 3, 16, 16

    def inputs(ctx, seed):
        q, kp, vp, pt, cl = _case(cuda, torch.bfloat16, hkv, group, ps, ctx,
                                  seed=seed)
        num_tiles = pt.shape[1] * (ps // tile)
        kw = dict(num_segments=16, tiles_per_segment=-(-num_tiles // 16),
                  scale=0.125)
        return (q.reshape(len(ctx), hkv, group, 64),
                kp.reshape(hkv, -1, 1, ps, 64),
                vp.reshape(hkv, -1, 1, ps, 64), pt, cl), kw

    def check(args, kw):
        got = K.paged_decode_segmented_merged(*args, **kw)
        pair = K.segment_reduce(*K.paged_decode_segmented(*args, **kw),
                                torch.bfloat16)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(pair))
        assert not any(c.any() for c in K._COUNTERS.values())
        return got

    small = inputs([2048, 0, 300, 17], 7)
    large = inputs([2048, 1000, 0, 1, 517, 64, 999, 2047, 33], 8)
    first = check(*small)
    for _ in range(2):
        assert torch.equal(_bits(check(*small)), _bits(first))
    check(*large)
    assert torch.equal(_bits(check(*small)), _bits(first))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", UNIFIED_CASES)
def test_unified_op_matches_plain(cuda, dtype, case):
    """Decode region + a fresh and a resumed chunk through ops on the card
    vs the same call on the CPU (plain versions)."""
    hkv, group, ps, tile, ctx, d = case
    ms = len(ctx)
    q, kp, vp, pt, cl = _case(cuda, dtype, hkv, group, ps, ctx + [40, 90],
                              d=d, seed=1)
    qlens = torch.tensor([1] * ms + [40, 33], dtype=torch.int32)
    qsl = torch.cat([torch.zeros(1, dtype=torch.int32),
                     torch.cumsum(qlens, 0, dtype=torch.int32)])
    t = ms + 128
    qt = torch.randn((t, q.shape[1], q.shape[2]),
                     generator=torch.Generator().manual_seed(2)).to(dtype)
    args = [qt, kp, vp, pt, cl, qsl, qlens]
    for variant in ("gqa", "segmented", "baseline"):
        kw = dict(num_decode_seqs=ms, variant=variant, tile=tile,
                  num_segments=4)
        got = ops.paged_attention_unified(*(a.to(cuda) for a in args), **kw)
        want = ops.paged_attention_unified(*(a.cpu() for a in args), **kw)
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unified_op_at_verify_shapes_matches_plain(cuda, dtype):
    """The speculative verify step's shapes at smollm's heads (Hkv 3,
    group 3, D 64, page 16): 8 decode rows at contexts of 128-1100, then 8
    chunk rows of q = s + 1 in 2..5 ending at contexts of 130-1100, packed
    back to back, through ops on the card vs the CPU."""
    ctx = [128, 301, 517, 640, 777, 901, 1033, 1100]
    qs = [2, 3, 4, 5, 5, 4, 3, 2]
    q, kp, vp, pt, cl = _case(cuda, dtype, 3, 3, 16,
                              ctx + [130, 260, 515, 641, 799, 900, 1003,
                                     1100], seed=5)
    qlens = torch.tensor([1] * 8 + qs, dtype=torch.int32)
    qsl = torch.cat([torch.zeros(1, dtype=torch.int32),
                     torch.cumsum(qlens, 0, dtype=torch.int32)])
    t = 8 + 32  # the token bucket: max_seqs + pow2(28)
    qt = torch.randn((t, 9, 64),
                     generator=torch.Generator().manual_seed(6)).to(dtype)
    args = [qt, kp, vp, pt, cl, qsl, qlens]
    for variant in ("gqa", "segmented"):
        kw = dict(num_decode_seqs=8, variant=variant, num_segments=16)
        K.reset_launches()
        got = ops.paged_attention_unified(*(a.to(cuda) for a in args), **kw)
        assert K.LAUNCHES["paged_prefill_qblock"] == 1
        want = ops.paged_attention_unified(*(a.cpu() for a in args), **kw)
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   atol=ATOL[dtype], rtol=0)


def test_engine_on_card_matches_cpu(cuda):
    """Reduced smollm-135m in fp32: greedy tokens through the CUDA kernels
    equal those through the plain versions on the CPU, and every kernel of
    the packed step launched."""
    cfg = reduced(ARCHS["smollm-135m"]).replace(dtype="float32")
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, size=n)))
               for n in (5, 40, 17, 70, 3, 33)]
    outs = []
    for dev in (cuda, torch.device("cpu")):
        eng = Engine(cfg, weights.init_random(cfg, 0, device=dev),
                     max_seqs=4, num_pages=64, max_model_len=256,
                     enable_chunked_prefill=True, max_prefill_tokens=32,
                     device=dev)
        if dev.type == "cuda":
            K.reset_launches()
        reqs = eng.generate([Request(prompt=p, max_new_tokens=6)
                             for p in prompts])
        if dev.type == "cuda":
            assert all(n > 0 for n in K.LAUNCHES.values()), K.LAUNCHES
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


def test_kernel_rejects_unsupported_head_dim(cuda):
    _, kp, _, pt, cl = _case(cuda, torch.float32, 1, 2, 16, [5])
    q = torch.zeros((1, 1, 2, 300), device=cuda)
    kt = torch.zeros((1, kp.shape[1], 1, 16, 300), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        K.paged_decode(q, kt, kt, pt, cl, cells_per_kv=1, scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        K.paged_decode(q.transpose(2, 3).contiguous().transpose(2, 3), kt,
                       kt, pt, cl, cells_per_kv=1, scale=1.0)
    # the bf16 tensor-core prefill has no D 40 kernel, and refuses it
    qb = torch.zeros(1, dtype=torch.int32, device=cuda)
    kt = torch.zeros((1, kp.shape[1], 1, 16, 40), device=cuda,
                     dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        K.paged_prefill_qblock(kt[:1, :1, 0, :2], kt, kt, qb, qb, pt, cl,
                               block_q=1, group=2, scale=1.0)


def test_decode_kernels_reject_misaligned_pages(cuda):
    """The streaming decode kernels read K/V in 16-byte vectors: pages that
    start off a 16-byte boundary raise before the launch."""
    q, kp, _, pt, cl = _case(cuda, torch.bfloat16, 1, 2, 16, [5])
    flat = torch.zeros(kp.numel() + 4, dtype=torch.bfloat16, device=cuda)
    kt = flat[4:].view(1, -1, 1, 16, 64)  # 8 bytes past the allocation
    qg = q.reshape(1, 1, 2, 64)
    n0 = dict(K.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        K.paged_decode(qg, kt, kt, pt, cl, cells_per_kv=1, scale=1.0)
    with pytest.raises(ValueError, match="16-byte"):
        K.paged_decode_segmented(qg, kt, kt, pt, cl, num_segments=1,
                                 tiles_per_segment=kt.shape[1], scale=1.0)
    k0 = dict(K.KERNEL_LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        K.paged_decode_segmented_merged(qg, kt, kt, pt, cl, num_segments=1,
                                        tiles_per_segment=kt.shape[1],
                                        scale=1.0)
    assert K.LAUNCHES == n0 and K.KERNEL_LAUNCHES == k0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_wide_block_uses_dynamic_shared_memory(cuda, dtype):
    """block_q 32 x group 4 rows at head_dim 128: the scalar fp32 kernel
    needs ~149 KB of shared memory per block, above the 48 KB default, so
    the launch opts in; in bf16 the tensor-core kernel takes the 128 rows
    as 8 warp slabs."""
    hkv, group, ps, d, block_q = 2, 4, 16, 128, 32
    ctx, qlens = [70, 300, 0], [70, 41, 0]
    _, kp, vp, pt, cl = _case(cuda, dtype, hkv, group, ps, ctx, d=d, seed=3)
    qlens = torch.tensor(qlens, dtype=torch.int32, device=cuda)
    qsl = torch.cat([torch.zeros(1, dtype=torch.int32, device=cuda),
                     torch.cumsum(qlens, 0, dtype=torch.int32)])
    qb_seq, qb_pos0, _, _ = ops.build_qblock_metadata(
        qsl, qlens, cl, block_q=block_q, num_q_blocks=8)
    qp = torch.randn((8, hkv, block_q * group, d),
                     generator=torch.Generator().manual_seed(4)).to(dtype)
    kt = kp.reshape(hkv, -1, 1, ps, d)
    vt = vp.reshape(hkv, -1, 1, ps, d)
    args = (qp.to(cuda), kt, vt, qb_seq, qb_pos0, pt, cl)
    kw = dict(block_q=block_q, group=group, scale=d ** -0.5)
    got = K.paged_prefill_qblock(*args, **kw)
    want = K.paged_prefill_qblock_plain(*args, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL[dtype],
                               rtol=0)
    assert (got[qb_seq < 0] == 0).all()


MMA_PREFILL_CASES = [  # hkv, group, page, D, block_q, contexts, query lens
    # 128 rows a Q-Block (over 64), D 128, page 24, an empty slot (context
    # 0), a resumed chunk
    (2, 8, 24, 128, 16, [0, 70, 300, 37], [0, 70, 41, 37]),
    # group 1, 16 rows a Q-Block: a block's 4 warps straddle sequences
    (4, 1, 16, 64, 16, [50, 17, 100, 3, 64], [50, 17, 100, 3, 64]),
    # smollm's 48 rows, page 24, resumed chunks
    (3, 3, 24, 64, 16, [200, 1312, 5], [200, 312, 5]),
    # 24 rows a Q-Block: the second warp slab is half empty
    (2, 3, 16, 64, 8, [33, 90, 0], [33, 20, 0]),
    # qwen2-vl-2b's heads: 16 x 6 = 96 rows a Q-Block (6 slabs), D 128, a
    # fresh and a resumed chunk, an empty slot
    (2, 6, 16, 128, 16, [200, 1312, 0, 37], [200, 312, 0, 37]),
]


@pytest.mark.parametrize("case", MMA_PREFILL_CASES)
def test_prefill_mma_kernel_matches_plain(cuda, case):
    """The bf16 tensor-core Q-Block prefill against its plain version:
    dead Q-blocks are exact zeros; the launch is counted."""
    hkv, group, ps, d, block_q, ctx, qlens = case
    _, kp, vp, pt, cl = _case(cuda, torch.bfloat16, hkv, group, ps, ctx,
                              d=d, seed=5)
    qlens = torch.tensor(qlens, dtype=torch.int32, device=cuda)
    qsl = torch.cat([torch.zeros(1, dtype=torch.int32, device=cuda),
                     torch.cumsum(qlens, 0, dtype=torch.int32)])
    nqb = int(qsl[-1]) // block_q + len(ctx) + 2  # static max: dead blocks
    qb_seq, qb_pos0, _, _ = ops.build_qblock_metadata(
        qsl, qlens, cl, block_q=block_q, num_q_blocks=nqb)
    qp = torch.randn((nqb, hkv, block_q * group, d),
                     generator=torch.Generator().manual_seed(6)).to(
                         torch.bfloat16).to(cuda)
    kt = kp.reshape(hkv, -1, 1, ps, d)
    vt = vp.reshape(hkv, -1, 1, ps, d)
    args = (qp, kt, vt, qb_seq, qb_pos0, pt, cl)
    kw = dict(block_q=block_q, group=group, scale=d ** -0.5)
    n0 = K.LAUNCHES["paged_prefill_qblock"]
    got = K.paged_prefill_qblock(*args, **kw)
    want = K.paged_prefill_qblock_plain(*args, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES["paged_prefill_qblock"] == n0 + 1
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)
    assert (qb_seq < 0).any() and (got[qb_seq < 0] == 0).all()


FLASH_CASES = [  # B, Sq, Skv, Hq, Hkv, D, causal, q_offset
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 64, 64, 8, 8, 128, True, 0),  # MHA, D 128
    (2, 32, 128, 4, 1, 64, True, 96),  # q_offset
    (1, 128, 128, 16, 2, 128, False, 0),  # bidirectional, 8 rows a token
    (1, 100, 100, 6, 2, 40, True, 0),  # ragged KV tile, D 40
    (1, 64, 64, 2, 1, 256, True, 0),  # D 256: ~219 KB of shared memory
    (1, 64, 64, 12, 2, 128, True, 0),  # qwen2-vl-2b's heads: group 6
]


def _flash_inputs(dev, dtype, case, seed=0):
    b, sq, skv, hq, hkv, d = case[:6]
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dtype).to(dev) for shape in
            ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d))]


def _flash_packed(q, k, v, causal, off):
    """The kernel's packed inputs and keyword arguments, as ops builds
    them."""
    hq, hkv, d = q.shape[2], k.shape[2], q.shape[3]
    group = hq // hkv
    bq = fops.pick_block_q(q.shape[1], group)
    qp = fops.pack_q(q, hkv).reshape(-1, q.shape[1] // bq, bq * group, d)
    kp, vp = (x.permute(0, 2, 1, 3).reshape(x.shape[0] * hkv, x.shape[1],
                                             d).contiguous()
              for x in (k, v))
    return qp, kp, vp, dict(block_q=bq, group=group, scale=d ** -0.5,
                            causal=causal, q_offset=off)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, dtype, case):
    """fp32 on the scalar kernel (any head dim, multiple of 8, up to 256);
    bf16 on the tensor-core kernel, which refuses a head dim other than 64
    or 128 rather than send it to a slower kernel."""
    q, k, v = _flash_inputs(cuda, dtype, case)
    causal, off = case[6:]
    qp, kp, vp, kw = _flash_packed(q, k, v, causal, off)
    if dtype == torch.bfloat16 and q.shape[3] not in MMA_HEAD_DIMS:
        with pytest.raises(ValueError, match="head_dim"):
            FK.flash_attention_fwd(qp.contiguous(), kp, vp, **kw)
        return
    n0 = FK.LAUNCHES["flash_attention_fwd"]
    o, lse = FK.flash_attention_fwd(qp.contiguous(), kp, vp, **kw)
    want_o, want_lse = FK.flash_attention_fwd_plain(qp, kp, vp, **kw)
    torch.cuda.synchronize()
    assert FK.LAUNCHES["flash_attention_fwd"] == n0 + 1
    assert o.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(o.float(), want_o.float(), atol=ATOL[dtype],
                               rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)


MMA_FLASH_CASES = [  # B, Sq, Skv, Hq, Hkv, D, causal, q_offset
    (1, 5, 5, 9, 3, 64, True, 0),  # 15 rows: one partial warp slab
    (2, 24, 24, 6, 2, 64, True, 0),  # 24 rows a q-block, 72 a slice
    (1, 40, 136, 16, 2, 128, True, 96),  # D 128, group 8, q_offset
    (1, 64, 100, 8, 2, 128, False, 0),  # bidirectional, ragged KV tile
    (2, 192, 192, 4, 4, 64, True, 0),  # MHA, three 64-key tiles
    (1, 16, 0, 4, 2, 64, False, 0),  # no keys: every row dead
    (2, 64, 64, 12, 2, 128, True, 0),  # qwen2-vl-2b: group 6, 48 rows
]


@pytest.mark.parametrize("case", MMA_FLASH_CASES)
def test_flash_mma_kernel_matches_plain(cuda, case):
    """The bf16 tensor-core flash forward against its plain version at
    row counts that are not multiples of 16, D 128, q_offset > 0, a ragged
    last tile, and no keys at all (o exact zeros, lse -0.7 * f32 max)."""
    q, k, v = _flash_inputs(cuda, torch.bfloat16, case, seed=7)
    qp, kp, vp, kw = _flash_packed(q, k, v, *case[6:])
    n0 = FK.LAUNCHES["flash_attention_fwd"]
    o, lse = FK.flash_attention_fwd(qp.contiguous(), kp, vp, **kw)
    want_o, want_lse = FK.flash_attention_fwd_plain(qp, kp, vp, **kw)
    torch.cuda.synchronize()
    assert FK.LAUNCHES["flash_attention_fwd"] == n0 + 1
    torch.testing.assert_close(o.float(), want_o.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
    if k.shape[1] == 0:
        assert (o == 0).all() and (lse == NEG_INF).all()


@pytest.mark.parametrize("case", [(2, 256, 256, 9, 3, 64, True, 0),
                                  (1, 64, 160, 4, 2, 64, True, 96)])
def test_flash_gradient_on_card_matches_cpu(cuda, case):
    """fp32 autograd through the kernel's forward and the recompute
    backward on the card vs the same on the CPU (plain forward)."""
    causal, off = case[6:]
    inputs = _flash_inputs("cpu", torch.float32, case, seed=1)
    w = torch.randn(inputs[0].shape, generator=torch.Generator().manual_seed(2))
    grads = []
    for dev in (cuda, torch.device("cpu")):
        xs = [x.to(dev).requires_grad_(True) for x in inputs]
        out = fops.flash_attention(*xs, causal=causal, q_offset=off)
        torch.sum(out * w.to(dev)).backward()
        grads.append([x.grad.cpu() for x in xs])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


def test_flash_kernel_rejects_unsupported_shapes(cuda):
    k = torch.zeros((1, 16, 300), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        FK.flash_attention_fwd(torch.zeros((1, 1, 2, 300), device=cuda), k,
                               k, block_q=1, group=2, scale=1.0, causal=True,
                               q_offset=0)
    k = torch.zeros((1, 16, 40), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):  # no bf16 D 40 kernel
        FK.flash_attention_fwd(torch.zeros_like(k[:, None, :6]), k, k,
                               block_q=2, group=3, scale=1.0, causal=True,
                               q_offset=0)
    k = torch.zeros((1, 16, 64), device=cuda)
    with pytest.raises(ValueError, match="rows"):
        FK.flash_attention_fwd(torch.zeros((1, 1, 128, 64), device=cuda), k,
                               k, block_q=16, group=8, scale=1.0,
                               causal=True, q_offset=0)


SSD_CASES = [  # B, L, H, P, N, G, chunk
    (2, 64, 4, 32, 16, 2, 16),  # the cases of tests/test_kernels_mamba2.py
    (1, 128, 2, 64, 64, 1, 32),
    (2, 32, 8, 16, 8, 8, 8),
    (2, 256, 4, 128, 64, 1, 128),  # zamba2's widths, two column blocks
    (1, 16, 4, 128, 64, 1, 16),  # a short prompt: one chunk of 16
    (1, 96, 3, 48, 24, 3, 24),  # ragged: P 48 of 64 columns, Q 24 of 32
    # across the bf16 kernel's MMA tiles: P 40 (two and a half n-tile
    # pairs), N 8 (half a k-block), Q 40 (two and a half warp slabs); P 20
    # and N 12 (rows of 40 and 24 bytes: copied element-wise, not by
    # 16-byte cp.async), Q 12
    (2, 80, 2, 40, 8, 1, 40),
    (1, 36, 2, 20, 12, 2, 12),
]


def _ssd_inputs(dev, dtype, case, seed=0, *, x_scale=1.0, state_scale=1.0):
    """x, dt, a, b, c, d as tests/test_kernels_mamba2.py draws them, plus
    a nonzero initial state (x and the state scaled as given)."""
    b, l, h, p, n, g, _ = case
    rng = np.random.default_rng(seed)
    t = lambda a, dt=torch.float32: torch.from_numpy(  # noqa: E731
        np.asarray(a, np.float32)).to(dt).to(dev)
    return (t(x_scale * rng.standard_normal((b, l, h, p)), dtype),
            t(np.abs(rng.standard_normal((b, l, h))) * 0.5 + 0.01),
            t(-np.abs(rng.standard_normal(h)) - 0.1),
            t(rng.standard_normal((b, l, g, n)), dtype),
            t(rng.standard_normal((b, l, g, n)), dtype),
            t(rng.standard_normal(h)),
            t(state_scale * rng.standard_normal((b, h, n, p))))


def _ssd_close(got, want, dtype):
    scale = max(1.0, float(want.abs().max()))
    atol = 1e-5 * scale if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_kernel_matches_plain(cuda, dtype, case):
    x, dt, a, b, c, _, s0 = _ssd_inputs(cuda, dtype, case)
    chunk = case[-1]
    bsz, l, h, _ = x.shape
    la = (dt * a).reshape(bsz, l // chunk, chunk, h)
    a_cum = sops.chunk_cumsum(la).reshape(bsz, l, h)
    n0 = SK.LAUNCHES["ssd_chunked_fwd"]
    y, s = SK.ssd_chunked_fwd(x, dt, b, c, a_cum, s0, chunk=chunk)
    want_y, want_s = SK.ssd_chunked_fwd_plain(x, dt, b, c, a_cum, s0,
                                              chunk=chunk)
    torch.cuda.synchronize()
    assert SK.LAUNCHES["ssd_chunked_fwd"] == n0 + 1
    assert y.dtype == s.dtype == torch.float32
    _ssd_close(y, want_y, dtype)
    _ssd_close(s, want_s, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_large_state(cuda, dtype):
    """An initial state of ~100 under small x: y is ~exp(a) C S_in, up to
    ~10^3.  The bf16 kernel feeds S_in to the tensor cores as bf16 hi + lo
    halves: one rounding of S_in (2^-9 of ~100 a term, over 64 terms)
    would miss the absolute 2e-2; the two halves keep ~2^-17."""
    case = (2, 256, 4, 128, 64, 1, 128)
    x, dt, a, b, c, _, s0 = _ssd_inputs(cuda, dtype, case, seed=4,
                                        x_scale=0.01, state_scale=100.0)
    bsz, l, h, _ = x.shape
    a_cum = sops.chunk_cumsum((dt * a).reshape(bsz, l // 128, 128, h)
                              ).reshape(bsz, l, h)
    y, s = SK.ssd_chunked_fwd(x, dt, b, c, a_cum, s0, chunk=128)
    want_y, want_s = SK.ssd_chunked_fwd_plain(x, dt, b, c, a_cum, s0,
                                              chunk=128)
    assert float(want_y.abs().max()) > 100.0
    _ssd_close(y, want_y, dtype)
    _ssd_close(s, want_s, dtype)


def test_mamba2_ssd_on_card_matches_cpu(cuda):
    """The op (cumsum, kernel, D skip) on the card vs on the CPU, fp32."""
    case = (2, 256, 4, 128, 64, 1, 128)
    args = _ssd_inputs("cpu", torch.float32, case, seed=1)
    outs = [sops.mamba2_ssd(*(t.to(dev) for t in args[:6]), chunk=case[-1],
                            initial_state=args[6].to(dev))
            for dev in (cuda, torch.device("cpu"))]
    for got, want in zip(*outs):
        _ssd_close(got.cpu(), want, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_rejects_unsupported_shapes(cuda, dtype):
    x, dt, a, b, c, _, s0 = _ssd_inputs(cuda, dtype,
                                        (1, 256, 2, 16, 8, 1, 256))
    a_cum = torch.zeros_like(dt)
    n0 = SK.LAUNCHES["ssd_chunked_fwd"]
    with pytest.raises(ValueError, match="128"):
        SK.ssd_chunked_fwd(x, dt, b, c, a_cum, s0, chunk=256)
    b = torch.zeros((1, 256, 1, 80), device=cuda, dtype=dtype)
    s0 = torch.zeros((1, 2, 80, 16), device=cuda)
    with pytest.raises(ValueError, match="64"):
        SK.ssd_chunked_fwd(x, dt, b, b, a_cum, s0, chunk=128)
    assert SK.LAUNCHES["ssd_chunked_fwd"] == n0


def test_ssd_bf16_rejects_misaligned(cuda):
    """The tensor-core SSD copies x, B and C with 16-byte cp.async: an
    operand 2 bytes off a 16-byte boundary raises before the launch (and is
    not sent to the scalar kernel)."""
    case = (1, 32, 2, 16, 8, 1, 16)
    x, dt, a, b, c, _, s0 = _ssd_inputs(cuda, torch.bfloat16, case)
    a_cum = torch.zeros_like(dt)
    for which in range(3):
        args = [x, b, c]
        flat = torch.zeros(args[which].numel() + 1, dtype=torch.bfloat16,
                           device=cuda)
        args[which] = flat[1:].view(args[which].shape)
        n0 = dict(SK.KERNEL_LAUNCHES)
        with pytest.raises(ValueError, match="16-byte"):
            SK.ssd_chunked_fwd(args[0], dt, args[1], args[2], a_cum, s0,
                               chunk=16)
        assert SK.KERNEL_LAUNCHES == n0


def test_hybrid_engine_on_card_matches_cpu(cuda):
    """Reduced zamba2 in fp32 through the padded step: greedy tokens with
    the SSD and paged kernels on the card equal those of the plain versions
    on the CPU, and the SSD ran once per Mamba2 layer per prefill."""
    cfg = reduced(ARCHS["zamba2-1.2b"]).replace(dtype="float32")
    rng = np.random.default_rng(1)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, size=n)))
               for n in (12, 20, 7, 40)]
    outs = []
    for dev in (cuda, torch.device("cpu")):
        eng = Engine(cfg, weights.init_random(cfg, 0, device=dev),
                     max_seqs=2, num_pages=32, max_model_len=128, device=dev)
        SK.reset_launches()
        reqs = eng.generate([Request(prompt=p, max_new_tokens=5)
                             for p in prompts])
        if dev.type == "cuda":
            n_mamba = len(eng.model.mamba)
            assert SK.LAUNCHES["ssd_chunked_fwd"] == \
                n_mamba * eng.device_calls["prefill"] > 0
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


# (B, L, H, P, chunk): tests/test_kernels_mlstm.py's cases, a short prompt
# and xlstm-350m's serve shape
MLSTM_CASES = [(2, 64, 3, 16, 16), (1, 128, 4, 64, 32), (2, 32, 1, 32, 8),
               (8, 16, 4, 512, 16), (8, 1024, 4, 512, 64),
               # across the bf16 kernel's MMA tiles: P 16 (C^T halves of one
               # k-block), Q 8 (half a 16-row slab); P 40 and Q 24; P 20
               # (rows of 40 bytes: copied element-wise), Q 12; P 136 (a
               # second, ragged column block)
               (2, 24, 2, 16, 8), (1, 48, 2, 40, 24), (1, 24, 1, 20, 12),
               (1, 64, 2, 136, 32)]


def _mlstm_inputs(dev, dtype, case, *, state, seed=0, qkv_scale=1.0,
                  state_scale=0.1):
    b, l, h, p, chunk = case
    rng = np.random.default_rng(seed)
    t = lambda a, dt=torch.float32: torch.from_numpy(  # noqa: E731
        np.asarray(a, np.float32)).to(dt).to(dev)
    q, k, v = (t(qkv_scale * rng.standard_normal((b, l, h, p)), dtype)
               for _ in range(3))
    ig = rng.standard_normal((b, l, h))
    fg = rng.standard_normal((b, l, h)) + 2.0
    st = ((t(state_scale * rng.standard_normal((b, h, p, p))),
           t(state_scale * rng.standard_normal((b, h, p))),
           t(rng.standard_normal((b, h)))) if state
          else mops.zero_state(b, h, p, dev))
    return q, k, v, t(ig), t(fg), st


def _mlstm_gates(ig, fg, case):
    """(bcum, g) [B, L, H] from the gate preactivations, as the op forms
    them."""
    b, l, h, _, chunk = case
    lf = torch.nn.functional.logsigmoid(fg)
    bcum = chunk_cumsum(lf.reshape(b, l // chunk, chunk, h))
    g = torch.cummax(ig.reshape(b, l // chunk, chunk, h) - bcum, 2).values
    return bcum.reshape(b, l, h), g.reshape(b, l, h)


def _mlstm_close(got, want, rtol):
    scale = max(1.0, float(want.float().abs().max()))
    torch.testing.assert_close(got.float(), want.float(), atol=rtol * scale,
                               rtol=0)


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", MLSTM_CASES)
def test_mlstm_kernel_matches_plain(cuda, dtype, case, state):
    q, k, v, ig, fg, st = _mlstm_inputs(cuda, dtype, case, state=state)
    p, chunk = case[3], case[4]
    args = (q, k, v, ig, *_mlstm_gates(ig, fg, case), *st)
    n0 = MK.LAUNCHES["mlstm_chunked_fwd"]
    got = MK.mlstm_chunked_fwd(*args, chunk=chunk, scale=p ** -0.5)
    want = MK.mlstm_chunked_fwd_plain(*args, chunk=chunk, scale=p ** -0.5)
    torch.cuda.synchronize()
    assert MK.LAUNCHES["mlstm_chunked_fwd"] == n0 + 1
    assert got[0].dtype == dtype
    _mlstm_close(got[0], want[0], 2e-5 if dtype == torch.float32 else 8e-3)
    for a, w in zip(got[1:], want[1:]):
        _mlstm_close(a, w, 2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlstm_kernel_large_state(cuda, dtype):
    """An initial C and n of ~100 under small q, k, v, and m0 ~30 (above
    every chunk's gate max, so decay = 1 and the state stays ~100): h is
    ~(q C_in) / (q . n_in).  q and n0 are positive, so no row's
    denominator cancels towards 0 (where h would be ill-conditioned in any
    summation order).  The bf16 kernel feeds C_in to the tensor cores as
    bf16 hi + lo halves; the state keeps the fp32 bound (2e-5 x max)."""
    case = (2, 128, 2, 64, 32)
    q, k, v, ig, fg, (c0, n0, m0) = _mlstm_inputs(
        cuda, dtype, case, state=True, seed=5, qkv_scale=0.01,
        state_scale=100.0)
    args = (q.abs(), k, v, ig, *_mlstm_gates(ig, fg, case), c0, n0.abs(),
            m0 + 30.0)
    got = MK.mlstm_chunked_fwd(*args, chunk=32, scale=64 ** -0.5)
    want = MK.mlstm_chunked_fwd_plain(*args, chunk=32, scale=64 ** -0.5)
    assert float(want[1].abs().max()) > 100.0
    _mlstm_close(got[0], want[0], 2e-5 if dtype == torch.float32 else 8e-3)
    for a, w in zip(got[1:], want[1:]):
        _mlstm_close(a, w, 2e-5)


def test_ssm_kernels_choose_by_dtype(cuda):
    """bf16 reaches the tensor-core kernels, fp32 the scalar ones: the
    wrappers count each launch under the kernel the library launched."""
    ssd_case = (1, 32, 2, 16, 8, 1, 16)
    ml_case = (1, 32, 2, 16, 16)
    for dtype, ssd_k, ml_k in ((torch.bfloat16, "ssd_mma_kernel",
                                "mlstm_mma_kernel"),
                               (torch.float32, "ssd_fwd_kernel",
                                "mlstm_fwd_kernel")):
        x, dt, a, b, c, _, s0 = _ssd_inputs(cuda, dtype, ssd_case)
        q, k, v, ig, fg, st = _mlstm_inputs(cuda, dtype, ml_case, state=False)
        SK.reset_launches()
        MK.reset_launches()
        SK.ssd_chunked_fwd(x, dt, b, c, torch.zeros_like(dt), s0, chunk=16)
        MK.mlstm_chunked_fwd(q, k, v, ig, *_mlstm_gates(ig, fg, ml_case),
                             *st, chunk=16, scale=0.25)
        torch.cuda.synchronize()
        assert SK.KERNEL_LAUNCHES == {k_: int(k_ == ssd_k)
                                      for k_ in SK.KERNEL_LAUNCHES}
        assert MK.KERNEL_LAUNCHES == {k_: int(k_ == ml_k)
                                      for k_ in MK.KERNEL_LAUNCHES}
        assert SK.LAUNCHES == {"ssd_chunked_fwd": 1}
        assert MK.LAUNCHES == {"mlstm_chunked_fwd": 1}


def test_mlstm_on_card_matches_cpu(cuda):
    """The op (gates, cumsum, kernel) on the card vs on the CPU, fp32, with
    the extreme gates of tests/test_kernels_mlstm.py."""
    q, k, v, ig, fg, st = _mlstm_inputs("cpu", torch.float32,
                                        (1, 32, 2, 16, 8), state=False,
                                        seed=31)
    ig, fg = ig * 30.0, fg - 20.0
    outs = [mops.mlstm_chunked(*(x.to(dev) for x in (q, k, v, ig, fg)),
                               chunk=8)
            for dev in (cuda, torch.device("cpu"))]
    assert torch.isfinite(outs[0][0]).all()
    _mlstm_close(outs[0][0].cpu(), outs[1][0], 2e-5)
    for a, w in zip(outs[0][1], outs[1][1]):
        _mlstm_close(a.cpu(), w, 2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlstm_kernel_rejects_unsupported_shapes(cuda, dtype):
    n0 = MK.LAUNCHES["mlstm_chunked_fwd"]
    q, k, v, ig, fg, st = _mlstm_inputs(cuda, dtype,
                                        (1, 128, 1, 16, 128), state=False)
    gates = (ig, ig, ig)
    with pytest.raises(ValueError, match="64"):
        MK.mlstm_chunked_fwd(q, k, v, *gates, *st, chunk=128, scale=1.0)
    q, k, v, ig, fg, st = _mlstm_inputs(cuda, dtype,
                                        (1, 16, 1, 640, 16), state=False)
    gates = (ig, ig, ig)
    with pytest.raises(ValueError, match="512"):
        MK.mlstm_chunked_fwd(q, k, v, *gates, *st, chunk=16, scale=1.0)
    assert MK.LAUNCHES["mlstm_chunked_fwd"] == n0


def test_mlstm_bf16_rejects_misaligned(cuda):
    """The tensor-core mLSTM copies q, k and v with 16-byte cp.async: an
    operand 2 bytes off a 16-byte boundary raises before the launch (and
    is not sent to the scalar kernel)."""
    case = (1, 32, 2, 16, 16)
    q, k, v, ig, fg, st = _mlstm_inputs(cuda, torch.bfloat16, case,
                                        state=False)
    gates = _mlstm_gates(ig, fg, case)
    for which in range(3):
        args = [q, k, v]
        flat = torch.zeros(args[which].numel() + 1, dtype=torch.bfloat16,
                           device=cuda)
        args[which] = flat[1:].view(args[which].shape)
        n0 = dict(MK.KERNEL_LAUNCHES)
        with pytest.raises(ValueError, match="16-byte"):
            MK.mlstm_chunked_fwd(*args, ig, *gates, *st, chunk=16,
                                 scale=0.25)
        assert MK.KERNEL_LAUNCHES == n0


def test_xlstm_engine_on_card_matches_cpu(cuda):
    """Reduced xlstm in fp32 through the padded step: greedy tokens with
    the mLSTM kernel on the card equal those of the plain version on the
    CPU, and the kernel ran once per mLSTM layer per prefill."""
    cfg = reduced(ARCHS["xlstm-350m"]).replace(dtype="float32")
    rng = np.random.default_rng(2)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, size=n)))
               for n in (12, 20, 7, 40)]
    outs = []
    for dev in (cuda, torch.device("cpu")):
        eng = Engine(cfg, weights.init_random(cfg, 0, device=dev),
                     max_seqs=2, num_pages=32, max_model_len=128, device=dev)
        MK.reset_launches()
        reqs = eng.generate([Request(prompt=p, max_new_tokens=5)
                             for p in prompts])
        if dev.type == "cuda":
            assert MK.LAUNCHES["mlstm_chunked_fwd"] == \
                len(eng.model.mlstm) * eng.device_calls["prefill"] > 0
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# CUDA graphs: the packed step and the padded decode step, captured
# ---------------------------------------------------------------------------


def _graphs_vs_eager(arch, prompts, dev, *, sampled=False, **eng_kw):
    """The same requests through an engine with CUDA graphs and one
    without, each from launch counters at 0: per step the tokens and the
    (debug) logits, then the caches, the compile events and the counters.
    Logits and caches must be bit-equal: the graphs replay the eager
    step's kernels on the same inputs."""
    cfg = reduced(ARCHS[arch]).replace(dtype="float32")
    model = weights.init_random(cfg, 0, device=dev)
    runs = []
    for graphs in (True, False):
        eng = Engine(cfg, model, device=dev, debug_logits=True,
                     cuda_graphs=graphs, **eng_kw)
        for i, p in enumerate(prompts):
            kw = (dict(temperature=0.9, top_k=30, top_p=0.8, seed=i)
                  if sampled and i % 2 else {})
            eng.add_request(Request(prompt=list(p), max_new_tokens=6, **kw))
        for c in cuda_graphs.kernel_counters():
            c.update(dict.fromkeys(c, 0))
        toks, logits = [], []
        while eng.sched.has_work:
            toks.append(eng.step()["sampled_tokens"])
            logits.append(eng.last_step_logits.clone())
        torch.cuda.synchronize()
        runs.append(dict(eng=eng, toks=toks, logits=logits,
                         counts=[dict(c) for c in
                                 cuda_graphs.kernel_counters()]))
    g, e = runs
    assert g["eng"].graph_stats["captures"] > 0
    assert g["eng"].graph_stats["replays"] > 0
    assert e["eng"].graph_stats == {"captures": 0, "replays": 0,
                                    "capture_s": 0.0}
    assert g["eng"].compile_events == e["eng"].compile_events
    assert g["toks"] == e["toks"]
    for a, b in zip(g["logits"], e["logits"]):
        assert torch.equal(a, b)
    for group, leaves in e["eng"].cache.items():
        for name, t in leaves.items():
            assert torch.equal(g["eng"].cache[group][name], t), (group, name)
    assert g["counts"] == e["counts"]
    return g["eng"], e["eng"]


def _prompts_for(arch, lens, seed):
    rng = np.random.default_rng(seed)
    vocab = reduced(ARCHS[arch]).vocab_size
    return [list(map(int, rng.integers(1, vocab, size=n))) for n in lens]


def test_graphed_packed_step_matches_eager(cuda):
    """Reduced smollm-135m, fp32, chunked prefill at 32 tokens, greedy and
    sampled (temperature, top-k, top-p) requests: the graphed packed step
    gives the eager step's tokens, logits, pages and launch counts."""
    geng, _ = _graphs_vs_eager(
        "smollm-135m", _prompts_for("smollm-135m", (5, 40, 17, 70, 3, 33), 0),
        cuda, sampled=True, max_seqs=4, num_pages=64, max_model_len=256,
        enable_chunked_prefill=True, max_prefill_tokens=32)
    assert all(isinstance(geng._compiled[k], cuda_graphs.GraphedStep)
               for k in geng.compile_events)


def test_graphed_packed_step_matches_eager_mrope(cuda):
    """Reduced qwen2-vl-2b (M-RoPE: the [3, 1, T] positions a static input
    of the graphs, q / k / v biases), fp32, chunked at 32, greedy and
    sampled requests: the graphed packed step equals the eager step bit
    for bit."""
    geng, _ = _graphs_vs_eager(
        "qwen2-vl-2b", _prompts_for("qwen2-vl-2b", (5, 40, 17, 70, 3, 33), 1),
        cuda, sampled=True, max_seqs=4, num_pages=64, max_model_len=256,
        enable_chunked_prefill=True, max_prefill_tokens=32)
    shapes = {tuple(geng._compiled[k].inputs.host["positions"].shape)
              for k in geng.compile_events}
    assert shapes and all(len(sh) == 3 and sh[0] == 3 for sh in shapes)


def test_graphed_packed_step_matches_eager_under_preemption(cuda):
    """13 pages for four requests that need ~18: preemption rewrites the
    page tables the graphs read from their static buffers."""
    geng, _ = _graphs_vs_eager(
        "smollm-135m", _prompts_for("smollm-135m", (40, 33, 47, 20), 7),
        cuda, max_seqs=4, num_pages=13, max_model_len=128)
    assert geng.graph_stats["replays"] > 0


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-350m"])
def test_graphed_padded_decode_matches_eager(cuda, arch):
    """The padded step: the decode step captured (the prefill eager), the
    same tokens, logits, KV pages and recurrent states as eager."""
    geng, _ = _graphs_vs_eager(
        arch, _prompts_for(arch, (12, 20, 7, 40), 1), cuda, max_seqs=2,
        num_pages=32, max_model_len=128)
    kinds = {k[0]: type(geng._compiled[k]) for k in geng.compile_events}
    assert kinds == {"prefill": cuda_graphs.EagerStep,
                     "decode": cuda_graphs.GraphedStep}


SPEC_PROMPTS = [[5, 9, 17, 3] * 6, ([5, 9, 17, 3] * 5)[:18],
                [11, 4, 250, 7, 93, 1, 42, 8, 300], [5, 9, 17, 3] * 3]


def test_graphed_spec_step_matches_eager(cuda):
    """A speculative engine (draft_k 4), greedy and sampled requests: the
    graphed verify step gives the eager step's tokens, logits, pages,
    spec stats and launch counts; one device call a step."""
    geng, eeng = _graphs_vs_eager(
        "smollm-135m", SPEC_PROMPTS, cuda, sampled=True, speculative=True,
        draft_k=4, max_seqs=4, num_pages=64, max_model_len=256)
    assert geng.spec_stats == eeng.spec_stats
    assert geng.spec_stats["proposed"] > 0
    assert dict(geng.device_calls) == {"unified": geng.step_idx}
    assert geng.alloc.free_pages == geng.num_pages - 1


def test_graphed_two_dispatch_matches_eager(cuda):
    """`fused_sampling=False`: the graphed packed launch and the eager
    sampling dispatch after it, against the eager step; and the fused
    engine's tokens."""
    geng, _ = _graphs_vs_eager(
        "smollm-135m", _prompts_for("smollm-135m", (5, 40, 17, 70), 2),
        cuda, sampled=True, fused_sampling=False, max_seqs=4, num_pages=64,
        max_model_len=256)
    n = geng.step_idx
    assert dict(geng.device_calls) == {"unified": n, "sample": n}


def test_spec_engine_on_card_matches_cpu(cuda):
    """Reduced smollm-135m in fp32, speculative, greedy: the card's tokens
    and spec stats equal the CPU's (plain versions)."""
    cfg = reduced(ARCHS["smollm-135m"]).replace(dtype="float32")
    runs = []
    for dev in (cuda, torch.device("cpu")):
        eng = Engine(cfg, weights.init_random(cfg, 0, device=dev),
                     max_seqs=4, num_pages=64, max_model_len=256,
                     speculative=True, draft_k=4, device=dev)
        reqs = eng.generate([Request(prompt=list(p), max_new_tokens=16)
                             for p in SPEC_PROMPTS])
        runs.append(([r.output for r in reqs], dict(eng.spec_stats)))
    assert runs[0] == runs[1]
    assert runs[0][1]["accepted"] > 0


def test_launch_counters_follow_replays(cuda):
    """A replayed step adds the launches its capture recorded: the graphed
    run counts exactly what the eager run counts, every paged kernel
    included (zamba2: the prefill eager, the decode replayed)."""
    for arch in ("smollm-135m", "zamba2-1.2b"):
        _graphs_vs_eager(
            arch, _prompts_for(arch, (12, 20, 7, 40), 3), cuda, max_seqs=2,
            num_pages=32, max_model_len=128)
        assert K.LAUNCHES["paged_decode"] + \
            K.LAUNCHES["paged_decode_segmented"] > 0


def test_merge_counters_a_graph_captured_survive_a_larger_launch(cuda):
    """A graph captures the folded C3 launch with the counter buffer of its
    stream; a larger launch on that stream replaces the buffer.  The old
    one stays alive and zeroed, and the graph still replays on it and
    gives the eager bits."""
    q, kp, vp, pt, cl = _case(cuda, torch.float32, 3, 3, 16, [0, 1, 17, 300])
    s, hq, d = q.shape
    kt, vt = (x.reshape(3, -1, 1, 16, d) for x in (kp, vp))
    kw = dict(num_segments=4, tiles_per_segment=5, scale=0.125)
    qq = q.reshape(s, 3, 3, d)
    want = K.paged_decode_segmented_merged(qq, kt, vt, pt, cl, **kw)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        K.paged_decode_segmented_merged(qq, kt, vt, pt, cl, **kw)  # warm-up
    key = (cuda.index if cuda.index is not None else 0, side.cuda_stream)
    buf = K._COUNTERS[key]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = K.paged_decode_segmented_merged(qq, kt, vt, pt, cl, **kw)
    q2, kp2, vp2, pt2, cl2 = _case(cuda, torch.float32, 3, 3, 16,
                                   [5, 40, 300, 9, 77, 100, 2, 64], seed=1)
    with torch.cuda.stream(side):
        K.paged_decode_segmented_merged(
            q2.reshape(8, 3, 3, d), *(x.reshape(3, -1, 1, 16, d)
                                      for x in (kp2, vp2)), pt2, cl2, **kw)
    torch.cuda.synchronize()
    assert K._COUNTERS[key] is not buf
    assert any(t is buf for t in K._RETIRED)
    assert not buf.any()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert not buf.any()


# ---------------------------------------------------------------------------
# the async double-buffered loop on the graphs
# ---------------------------------------------------------------------------


def _launches(eng):
    """Record each launching step's (debug) logits as `_finish_step`
    hands them over, in the synchronous `step()` and in `stream()`."""
    seen = []
    finish = eng._finish_step

    def record(flight):
        stats = finish(flight)
        if flight.pack is not None:
            seen.append(flight.logits)
        return stats

    eng._finish_step = record
    return seen


def _sync_and_async(dev, prompts, new=6, **eng_kw):
    """The same requests through `step()` and through `submit()` +
    `run()`, graphs on, each from launch counters at 0."""
    cfg = reduced(ARCHS["smollm-135m"]).replace(dtype="float32")
    model = weights.init_random(cfg, 0, device=dev)
    runs = []
    for drive in ("sync", "async"):
        eng = Engine(cfg, model, device=dev, debug_logits=True, **eng_kw)
        logits = _launches(eng)
        reqs = [Request(prompt=list(p), max_new_tokens=new, seed=i,
                        **(dict(temperature=0.9, top_k=30, top_p=0.8)
                           if i % 2 else {}))
                for i, p in enumerate(prompts)]
        for c in cuda_graphs.kernel_counters():
            c.update(dict.fromkeys(c, 0))
        if drive == "sync":
            eng.generate(reqs)
        else:
            for r in reqs:
                eng.submit(r)
            eng.run()
        torch.cuda.synchronize()
        runs.append(dict(eng=eng, reqs=reqs, logits=logits,
                         counts=[dict(c) for c in
                                 cuda_graphs.kernel_counters()]))
    return runs


def test_async_graphed_run_matches_sync_bit_for_bit(cuda):
    """Reduced smollm-135m, fp32, chunked prefill, greedy and sampled
    requests, graphs on: `run()` replays the graphs the synchronous run
    captures (one per key: `token_source` and `prev_tokens` are in every
    launch) and gives its tokens, its launch counters, its compile events
    and, launch by launch, its logits bit for bit; its KV pages end
    bit-equal too."""
    s, a = _sync_and_async(
        cuda, _prompts_for("smollm-135m", (5, 40, 17, 3), 0), max_seqs=4,
        num_pages=64, max_model_len=256, enable_chunked_prefill=True,
        max_prefill_tokens=32)
    assert [r.output for r in a["reqs"]] == [r.output for r in s["reqs"]]
    assert a["eng"].compile_events == s["eng"].compile_events
    assert a["eng"].graph_stats["captures"] == \
        s["eng"].graph_stats["captures"] > 0
    assert a["eng"].graph_stats["replays"] > 0
    assert a["counts"] == s["counts"]
    assert len(a["logits"]) == len(s["logits"])
    for x, y in zip(a["logits"], s["logits"]):
        assert torch.equal(x, y)
    for name, t in s["eng"].cache["attn"].items():
        assert torch.equal(a["eng"].cache["attn"][name], t), name


def test_async_pinned_buffers_alternate_across_preemption(cuda):
    """13 pages for four requests that need ~18 under `run()`: requests
    are preempted while their tokens are in flight.  Every launch's ids
    leave the card through the two pinned buffers in turn, each read
    once, and the sequences agree with the synchronous graphed run's."""
    s, a = _sync_and_async(
        cuda, _prompts_for("smollm-135m", (40, 33, 47, 20), 7), new=24,
        max_seqs=4, num_pages=13, max_model_len=128)
    copies = a["eng"]._copies
    assert all(b.is_pinned() for b in copies.bufs)
    assert copies.starts == a["eng"].device_calls["unified"]
    assert copies.pending == [False, False]
    # a preemption folds the output into the prompt (and max_new_tokens
    # counts again from there), at another step in each run: the
    # sequences agree as far as both go
    for x, y in zip(a["reqs"], s["reqs"]):
        x, y = x.prompt + x.output, y.prompt + y.output
        n = min(len(x), len(y))
        assert x[:n] == y[:n]
    assert any(len(r.prompt) > n for r, n in zip(a["reqs"],
                                                 (40, 33, 47, 20)))
    assert a["eng"].graph_stats["replays"] > 0


# ---------------------------------------------------------------------------
# the autotune loop on the card: every configuration of the spaces, the
# graphed timing, telemetry and the online refit
# ---------------------------------------------------------------------------

# the spaces at the heads of the models the engine serves (packed smollm,
# padded zamba2's attention) and qwen2.5-3b's (D 128, group 8)
TUNE_GEOMETRIES = {"smollm-135m": ("unified", "prefill"),
                   "zamba2-1.2b": ("decode", "prefill"),
                   "qwen2.5-3b": ("decode", "prefill")}


def _tune_call(space, x, cfg):
    nd = 8  # decode rows first, then a resumed and a fresh chunk
    if space == "decode":
        return ops.paged_attention_decode(
            x["q"][:nd], x["k"], x["v"], x["pt"][:nd], x["ctx"][:nd],
            variant=cfg.variant, tile=cfg.tile,
            num_segments=cfg.num_segments)
    if space == "prefill":
        return ops.paged_attention_prefill(
            x["q"][nd:], x["k"], x["v"], x["pt"][nd:], x["ctx"][nd:],
            x["qsl"][nd:] - nd, x["qlens"][nd:], block_q=cfg.block_q,
            tile=cfg.tile)
    return ops.paged_attention_unified(
        x["q"], x["k"], x["v"], x["pt"], x["ctx"], x["qsl"], x["qlens"],
        num_decode_seqs=nd, variant=cfg.variant, tile=cfg.tile,
        num_segments=cfg.num_segments, block_q=cfg.block_q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", sorted(TUNE_GEOMETRIES))
def test_every_tuned_configuration_matches_plain(cuda, monkeypatch, arch,
                                                 dtype):
    """Every KernelConfig of the sweep's spaces, through the ops the
    engine and the sweep call, against the same ops on the plain
    versions: 8 decode rows at contexts 0-2048, a chunk of 200 rows
    resumed at context 1112 and a fresh one of 100.  A configuration may
    be refused only before launch, by a documented limit
    (`LaunchLimitError`: the fp32 prefill's shared memory)."""
    from repro_torch.autotune import microbench as MB
    from repro_torch.kernels._common import LaunchLimitError

    cfg = ARCHS[arch]
    hkv, d = cfg.num_kv_heads, cfg.resolved_head_dim
    group = cfg.num_q_heads // hkv
    ctx = [0, 1, 17, 100, 511, 1000, 1500, 2048, 1312, 100]
    qlens = [1] * 8 + [200, 100]
    q, kp, vp, pt, ctx_t = _case(cuda, dtype, hkv, group, cfg.page_size,
                                 ctx, d=d, seed=5)
    g = torch.Generator().manual_seed(6)
    x = dict(q=torch.randn((sum(qlens), hkv * group, d), generator=g)
             .to(dtype).to(cuda), k=kp, v=vp, pt=pt, ctx=ctx_t,
             qsl=torch.tensor(np.cumsum([0] + qlens), dtype=torch.int32,
                              device=cuda),
             qlens=torch.tensor(qlens, dtype=torch.int32, device=cuda))
    spaces = {"decode": MB.DECODE_SPACE, "prefill": MB.PREFILL_SPACE,
              "unified": MB.UNIFIED_SPACE}
    refused = []
    for space in TUNE_GEOMETRIES[arch]:
        for kcfg in spaces[space]:
            try:
                got = _tune_call(space, x, kcfg)
            except LaunchLimitError:
                refused.append((space, kcfg))
                continue
            with monkeypatch.context() as m:
                for name in ("paged_decode", "paged_decode_segmented_merged",
                             "paged_prefill_qblock"):
                    m.setattr(K, name, getattr(K, name + "_plain"))
                want = _tune_call(space, x, kcfg)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            assert err <= ATOL[dtype], (space, kcfg, err)
            if space != "prefill":
                assert bool((got[0] == 0).all()), (space, kcfg)
    # only the fp32 prefill at qwen2.5-3b's 8-query groups outgrows a
    # block's shared memory (block_q 32 / 64: 256 / 512 rows of D 128)
    want_refused = [("prefill", c) for c in MB.PREFILL_SPACE
                    if c.block_q >= 32] \
        if (arch, dtype) == ("qwen2.5-3b", torch.float32) else []
    assert refused == want_refused


def test_graphed_measurements_are_device_times(cuda):
    """`_measure_on_device` and `_measure_unified_on_device` time the
    launches replayed in a CUDA graph: finite, positive, and the decode
    of 8 sequences of 2048 keys slower than of 1 of 64."""
    from repro_torch.autotune import costmodel as C
    from repro_torch.autotune import microbench as MB
    from repro_torch.core.attention.heuristics import KernelConfig

    def sc(ctx, q):
        return C.Scenario(num_seqs=len(ctx), context_lens=tuple(ctx),
                          query_lens=tuple(q), num_q_heads=9,
                          num_kv_heads=3, head_dim=64, page_size=16)

    seg = KernelConfig("segmented", tile=16, num_segments=8, block_q=32)
    small = MB._measure_on_device(sc([64], [1]), seg, warmup=2, iters=5)
    big = MB._measure_on_device(sc([2048] * 8, [1] * 8), seg, warmup=2,
                                iters=5)
    pre = MB._measure_on_device(sc([300, 700], [300, 200]), seg, warmup=2,
                                iters=5)
    uni = MB._measure_unified_on_device(sc([900, 300, 700], [1, 300, 200]),
                                        seg, warmup=2, iters=5)
    for t in (small, big, pre, uni):
        assert np.isfinite(t) and t > 0
    assert big > small
    assert MB.measure(sc([900, 300], [1, 300]), seg, use_hardware=True,
                      warmup=2, iters=5) > 0


def test_engine_with_telemetry_and_refit_matches_without(cuda, tmp_path):
    """Reduced smollm-135m, fp32, graphs on: an engine with
    `Telemetry(launch_timing_interval=1)` and an inline `RefitDaemon`
    (which hot-swaps refit trees between steps) gives the tokens of the
    same engine without them; the swaps happened, the telemetry counts
    its steps and captures, and the grid carries costs."""
    from repro_torch.core.attention import heuristics
    from repro_torch.obs import RefitDaemon, Telemetry

    cfg = reduced(ARCHS["smollm-135m"]).replace(dtype="float32")
    model = weights.init_random(cfg, 0, device=cuda)
    prompts = _prompts_for("smollm-135m", (18, 7, 24, 11), 9)
    outs = []
    try:
        for observed in (False, True):
            tel = Telemetry(launch_timing_interval=1) if observed else None
            daemon = (RefitDaemon(tel, out_dir=str(tmp_path), min_new=3)
                      if observed else None)
            eng = Engine(cfg, model, device=cuda, max_seqs=4, num_pages=64,
                         max_model_len=256, telemetry=tel, refit=daemon)
            reqs = [Request(prompt=list(p), max_new_tokens=10)
                    for p in prompts]
            for r in reqs:
                eng.submit(r)
            eng.run()
            outs.append([r.output for r in reqs])
    finally:
        heuristics.reset()
    assert outs[0] == outs[1]
    assert daemon.refits >= 1 and daemon.swaps >= 1
    assert tel.metrics.value("repro_steps_total") == eng.step_idx
    assert tel.metrics.value("repro_compile_events_total", kind="unified") \
        == eng.graph_stats["captures"] == len(eng.compile_events)
    grid = tel.latency_grid()["entries"]
    assert grid and all(e["flops"] > 0 and e["bytes_accessed"] > 0
                        for e in grid)


# ---------------------------------------------------------------------------
# the MoE family: the grouped expert GEMM and the MoE layer on the card
# ---------------------------------------------------------------------------

MOE_ARCH = "llama4-maverick-400b-a17b"


def _moe_ids(case, rows, e, g):
    if case == "uniform":
        ids = torch.randint(0, e, (rows,), generator=g)
    elif case == "one_expert":
        ids = torch.full((rows,), e // 2, dtype=torch.long)
    elif case == "empty":
        ids = torch.randint(0, 2, (rows,), generator=g) * (e - 1)
    else:  # "long": a group of 150 rows (three 64-row tiles)
        ids = torch.cat([torch.full((150,), 1, dtype=torch.long),
                         torch.randint(0, e, (rows - 150,), generator=g)])
    counts = torch.bincount(ids, minlength=e)
    return torch.cat([torch.zeros(1, dtype=torch.long),
                      counts.cumsum(0)]).to(torch.int32)


# deepseek-v2's experts (E 160, d 5120, ff 1536) at its padded prefill's
# 8 x 1024 tokens x top-6 rows
MOE_PREFILL_SHAPE, MOE_PREFILL_ROWS = (160, 5120, 1536), 49152


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["uniform", "one_expert", "empty", "long"])
@pytest.mark.parametrize("shape", [(8, 512, 1024), (5, 264, 200),
                                   MOE_PREFILL_SHAPE])
def test_grouped_gemm_matches_plain(cuda, dtype, case, shape):
    """Both launches (gate / up fused, then down) against the plain
    version: 8 and 200 rows (the "long" case: 200 only), a shape whose K
    and N are no multiple of the kernel's tiles, and deepseek-v2's
    prefill shape, also at its 49,152 rows (every routing: the
    one-expert skew puts them all on one expert).  At that shape the
    sums run over K 5120 / 1536 (another order than cuBLAS's in fp32;
    bf16 gate / up products whose rounding flips before silu): each
    element is also allowed 1e-5 (fp32) or 2^-6 (bf16, two ulps) of its
    own magnitude."""
    e, d, ff = shape
    prefill = shape == MOE_PREFILL_SHAPE
    rtol = {torch.float32: 1e-5, torch.bfloat16: 2 ** -6}[dtype] \
        if prefill else 0
    g = torch.Generator().manual_seed(len(case) + e)
    wg, wu = (torch.randn((e, d, ff), generator=g) * d ** -0.5
              for _ in range(2))
    wd = torch.randn((e, ff, d), generator=g) * ff ** -0.5
    wg, wu, wd = (w.to(cuda, dtype) for w in (wg, wu, wd))
    for rows in (8, 200) + ((MOE_PREFILL_ROWS,) if prefill else ()):
        if case == "long" and rows < 150:
            continue
        off = _moe_ids(case, rows, e, g).to(cuda)
        xs = torch.randn((rows, d), generator=g).to(cuda, dtype)
        GK.reset_launches()
        h = GK.grouped_gemm(xs, wg, off, wu)
        ys = GK.grouped_gemm(h, wd, off)
        torch.cuda.synchronize()
        kernel = "moe_wgmma_kernel" if dtype == torch.bfloat16 \
            else "moe_fp32_kernel"
        assert GK.KERNEL_LAUNCHES[kernel] == 2
        for got, want in ((h, GK.grouped_gemm_plain(xs, wg, off, wu)),
                          (ys, GK.grouped_gemm_plain(h, wd, off))):
            torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                       atol=ATOL[dtype])


def test_grouped_gemm_rejects_misaligned_bf16(cuda):
    """A start off the 16-byte boundary, and row strides that are no
    multiple of 16 bytes (TMA's): ValueError before any launch."""
    xs = torch.zeros(9 * 64 + 1, dtype=torch.bfloat16, device=cuda)[1:]
    w = torch.zeros((2, 64, 64), dtype=torch.bfloat16, device=cuda)
    off = torch.tensor([0, 4, 9], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        GK.grouped_gemm(xs.view(9, 64), w, off)
    GK.reset_launches()
    for k, n in ((60, 64), (64, 60)):
        xs = torch.zeros((9, k), dtype=torch.bfloat16, device=cuda)
        w = torch.zeros((2, k, n), dtype=torch.bfloat16, device=cuda)
        with pytest.raises(ValueError, match="16-byte"):
            GK.grouped_gemm(xs, w, off)
    assert GK.LAUNCHES["moe_grouped_gemm"] == 0


@pytest.mark.parametrize("glu", [True, False])
def test_grouped_gemm_launch_shape_matches_library(cuda, glu):
    """The package's mirror of the bf16 kernel's tile and grid
    (`launch_shape`) gives the library's own at decode, chunk and prefill
    shapes."""
    import ctypes

    lib = GK.library()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for r, e, n in ((8, 128, 8192), (520, 128, 5120), (48, 40, 1536),
                    (MOE_PREFILL_ROWS, 160, 1536), (1, 1, 8)):
        got = [ctypes.c_int() for _ in range(3)]
        lib.moe_grouped_gemm_shape(r, e, n, int(glu),
                                   *(ctypes.byref(v) for v in got))
        assert tuple(v.value for v in got) == GK.launch_shape(r, e, n, glu,
                                                              sms)


def _moe_layer(dev, dtype, top_k=2):
    from repro_torch.models.moe import MoE

    base = ARCHS[MOE_ARCH]
    cfg = base.replace(d_model=512, dtype=dtype, moe=base.moe.__class__(
        num_experts=16, top_k=top_k, num_shared_experts=1, d_ff_expert=256))
    moe = MoE(cfg, device=dev)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in moe.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * p.shape[-2] ** -0.5)
    return moe


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_graph_replay_matches_eager_without_host_syncs(cuda, dtype):
    """The MoE layer (top-2, 16 experts, a shared expert) eagerly under
    `set_sync_debug_mode("error")` (any host sync raises), then captured
    into a CUDA graph and replayed on new inputs: bit for bit the eager
    forward, the two grouped-GEMM launches counted."""
    moe = _moe_layer(cuda, dtype)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((1, 40, 512), generator=g).to(cuda, moe.w_gate.dtype)
    x2 = torch.randn((1, 40, 512), generator=g).to(cuda, moe.w_gate.dtype)
    GK.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            want = moe(x2)[0]
            s = torch.cuda.Stream()
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                moe(x)
            torch.cuda.current_stream().wait_stream(s)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                got = moe(x)[0]
            x.copy_(x2)
            graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert GK.LAUNCHES["moe_grouped_gemm"] == 6  # eager x 2, capture


def test_moe_on_card_matches_cpu(cuda):
    """The same layer in fp32 on the card and on the CPU: the same expert
    ids, outputs within 1e-4."""
    cpu = _moe_layer(torch.device("cpu"), "float32")
    card = _moe_layer(cuda, "float32")
    x = torch.randn((3, 33, 512), generator=torch.Generator().manual_seed(2))
    xt = x.reshape(-1, 512)
    assert torch.equal(card.route(xt.to(cuda))[1].cpu(), cpu.route(xt)[1])
    torch.testing.assert_close(card(x.to(cuda))[0].cpu(), cpu(x)[0],
                               rtol=0, atol=1e-4)


def test_graphed_moe_engine_matches_eager(cuda):
    """Reduced llama4-maverick (fp32), chunked prefill at 32: the graphed
    packed step gives the eager step's tokens, logits, pages and launch
    counts, the grouped GEMM among them."""
    geng, _ = _graphs_vs_eager(
        MOE_ARCH, _prompts_for(MOE_ARCH, (5, 40, 17, 70, 3, 33), 0), cuda,
        max_seqs=4, num_pages=64, max_model_len=256,
        enable_chunked_prefill=True, max_prefill_tokens=32)
    assert GK.LAUNCHES["moe_grouped_gemm"] == \
        2 * 4 * geng.device_calls["unified"]


def test_moe_engine_on_card_matches_cpu(cuda):
    """Reduced llama4-maverick in fp32, the card model a copy of the CPU
    one: greedy tokens through the kernels equal the plain versions'."""
    import copy

    cfg = reduced(ARCHS[MOE_ARCH]).replace(dtype="float32")
    model = weights.init_random(cfg, 0, device="cpu")
    outs = []
    for dev, m in ((cuda, copy.deepcopy(model).to(cuda)),
                   (torch.device("cpu"), model)):
        eng = Engine(cfg, m, max_seqs=4, num_pages=64, max_model_len=256,
                     enable_chunked_prefill=True, max_prefill_tokens=32,
                     device=dev)
        reqs = eng.generate([Request(prompt=p, max_new_tokens=6) for p in
                             _prompts_for(MOE_ARCH, (5, 40, 17, 70), 4)])
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


def test_capture_raises_on_a_host_sync(cuda):
    """What the MoE layer avoids: `torch.bincount` on a CUDA tensor reads
    its maximum on the host, which a capture refuses."""
    ids = torch.randint(0, 8, (64,), device=cuda)
    ids.bincount()  # eager: fine
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError):
        with torch.cuda.graph(graph):
            ids.bincount()
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# MLA (deepseek-v2): the latent decode and the flash forward at 192 / 128
# ---------------------------------------------------------------------------

MLA_DECODE_CASES = [  # heads, r, rope, page, contexts, segments (None: split)
    # deepseek-v2's widths: dead rows, mid-page and mid-tile ends, a 2048
    # context, on the split the serving path picks and on one segment
    (128, 512, 64, 16, [0, 1, 17, 300, 2048, 1000, 64, 65], None),
    (128, 512, 64, 16, [0, 1, 17, 300, 2048, 1000, 64, 65], 1),
    # 16 heads (rows 16-63 of the block's 64-head wgmma tile zero-filled),
    # 4 segments of 64 keys
    (16, 512, 64, 16, [200, 0, 129], 4),
    # a single page
    (128, 512, 64, 16, [16, 3, 0], None),
    # the wgmma kernel's edges: contexts around one 64-key tile and a
    # 4096 one, split and on one segment
    (128, 512, 64, 16, [63, 64, 65, 4096], None),
    (128, 512, 64, 16, [63, 64, 65, 4096], 1),
    # 64 heads: one block per (segment, sequence), no second half
    (64, 512, 64, 16, [100, 0, 700], None),
    # one sequence (a 256-page table) cut into the most segments the split
    # gives: 16 of 256 keys (test_torch_mla.py pins the split)
    (128, 512, 64, 16, [4080], None),
]
# fp32 also at the reduced widths (r 64, rope 32) and at 20 heads
MLA_FP32_CASES = MLA_DECODE_CASES + [
    (32, 64, 32, 16, [0, 40, 7, 130], 3),
    (20, 64, 32, 24, [100, 1, 0], None),
]


def _mla_case(dev, dtype, case, seed=0):
    h, r, rope, ps, ctx, _ = case
    g = torch.Generator().manual_seed(seed)
    s = len(ctx)
    np_ = -(-max(ctx) // ps) + 1
    p = s * np_ + 1
    q = torch.randn((s, h, r + rope), generator=g).to(dtype)
    kp = torch.randn((p, ps, r + rope), generator=g).to(dtype)
    pt = (torch.randperm(p - 1, generator=g)[: s * np_].reshape(s, np_)
          + 1).to(torch.int32)
    cl = torch.tensor(ctx, dtype=torch.int32)
    return [t.to(dev) for t in (q, kp, pt, cl)]


def _mla_check(cuda, dtype, case, sign=1.0):
    q, kp, pt, cl = _mla_case(cuda, dtype, case)
    r, nseg = case[1], case[5]
    scale = sign * (128 + case[2]) ** -0.5
    keys = pt.shape[1] * kp.shape[1]
    if nseg is None:
        nseg, seg = aops.split(q.shape[0], q.shape[1], keys,
                               torch.cuda.get_device_properties(
                                   cuda).multi_processor_count)
    else:
        seg = -(-keys // (nseg * AK.SEG_ALIGN)) * AK.SEG_ALIGN
    AK.reset_launches()
    got = AK.mla_decode(q, kp, pt, cl, v_dim=r, scale=scale,
                        num_segments=nseg, seg_keys=seg)
    want = AK.mla_decode_plain(q, kp, pt, cl, v_dim=r, scale=scale)
    torch.cuda.synchronize()
    assert AK.LAUNCHES["mla_decode"] == 1
    kern = "mla_wgmma_kernel" if dtype == torch.bfloat16 \
        else "mla_fp32_kernel"
    assert AK.KERNEL_LAUNCHES[kern] == 1
    assert AK.KERNEL_LAUNCHES["mla_merge_kernel"] == int(nseg > 1)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL[dtype],
                               rtol=0)
    assert not got[cl == 0].any()  # dead rows: exact zeros


@pytest.mark.parametrize("case", MLA_DECODE_CASES)
def test_mla_decode_mma_kernel_matches_plain(cuda, case):
    _mla_check(cuda, torch.bfloat16, case)


@pytest.mark.parametrize("case", MLA_FP32_CASES)
def test_mla_decode_fp32_kernel_matches_plain(cuda, case):
    _mla_check(cuda, torch.float32, case)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nseg", [None, 1])
def test_mla_decode_takes_a_negative_scale(cuda, dtype, nseg):
    """A negative scale turns the largest raw score into the smallest
    scaled one: each row's max is taken over the scaled scores."""
    _mla_check(cuda, dtype,
               (128, 512, 64, 16, [0, 1, 17, 300, 2048, 65], nseg), -1.0)


def test_mla_decode_pages_far_apart(cuda):
    """Every page of a tile far from its neighbours in a large pool (a
    page-table entry per 16 keys, strides of ~1,000 pages): the TMA boxes
    land where the plain gather puts them."""
    g = torch.Generator().manual_seed(11)
    ctx = [1000, 333]
    np_ = 64
    pool = 2 * np_ * 1009 + 1
    q = torch.randn((2, 128, 576), generator=g).to(torch.bfloat16)
    kp = torch.randn((pool, 16, 576), generator=g).to(torch.bfloat16)
    idx = torch.arange(2 * np_) * 1009 + 1
    pt = idx[torch.randperm(2 * np_, generator=g)].reshape(2, np_)
    args = [t.to(cuda) for t in (q, kp, pt.to(torch.int32),
                                 torch.tensor(ctx, dtype=torch.int32))]
    for nseg, seg in ((1, np_ * 16), (4, np_ * 4)):
        got = AK.mla_decode(*args, v_dim=512, scale=0.07, num_segments=nseg,
                            seg_keys=seg)
        want = AK.mla_decode_plain(*args, v_dim=512, scale=0.07)
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=ATOL[torch.bfloat16], rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nseg", [None, 1])
def test_mla_decode_ignores_nan_past_the_context(cuda, dtype, nseg):
    """Rows past each context (the rest of its last page, its later pages,
    the pages no table names) filled with NaN give the same bits as the
    pool with those rows zero: a whole-page load never lets them into
    P.V."""
    case = (128, 512, 64, 16, [63, 0, 65, 1000, 16, 130], nseg)
    q, kp, pt, cl = _mla_case(cuda, dtype, case)
    ps = kp.shape[1]
    live = torch.zeros(kp.shape[:2], dtype=torch.bool, device=cuda)
    for s, c in enumerate(cl.tolist()):
        keys = torch.arange(c, device=cuda)
        live[pt[s].long()[keys // ps], keys % ps] = True
    zero = torch.where(live[..., None], kp, torch.zeros_like(kp))
    nan = torch.where(live[..., None], kp, torch.full_like(kp, float("nan")))
    if nseg is None:
        nseg, seg = aops.split(q.shape[0], 128, pt.shape[1] * ps,
                               torch.cuda.get_device_properties(
                                   cuda).multi_processor_count)
    else:
        seg = -(-pt.shape[1] * ps // 64) * 64
    outs = [AK.mla_decode(q, pool, pt, cl, v_dim=512, scale=0.07,
                          num_segments=nseg, seg_keys=seg)
            for pool in (zero, nan)]
    want = AK.mla_decode_plain(q, zero, pt, cl, v_dim=512, scale=0.07)
    assert torch.isfinite(outs[1]).all()
    assert torch.equal(outs[0], outs[1])
    torch.testing.assert_close(outs[0].float(), want.float(),
                               atol=ATOL[dtype], rtol=0)


def test_mla_decode_rejects_what_it_does_not_take(cuda):
    q, kp, pt, cl = _mla_case(cuda, torch.bfloat16,
                              (32, 64, 32, 16, [5], None))
    with pytest.raises(ValueError, match="tensor-core"):  # reduced widths
        AK.mla_decode(q, kp, pt, cl, v_dim=64, scale=1.0)
    q, kp, pt, cl = _mla_case(cuda, torch.bfloat16,
                              (32, 512, 64, 16, [5], None))
    buf = torch.empty(q.numel() + 8, dtype=q.dtype, device=cuda)
    odd = buf[4:4 + q.numel()].view(q.shape)  # 8 bytes off 16
    odd.copy_(q)
    with pytest.raises(ValueError, match="aligned"):
        AK.mla_decode(odd, kp, pt, cl, v_dim=512, scale=1.0)
    q, kp, pt, cl = _mla_case(cuda, torch.bfloat16,
                              (64, 512, 64, 24, [30], None))
    with pytest.raises(LaunchLimitError, match="page size"):  # no TMA box
        AK.mla_decode(q, kp, pt, cl, v_dim=512, scale=1.0)


def test_mla_decode_captures_without_host_syncs(cuda):
    """The serving entry (split chosen from the shapes) under
    `set_sync_debug_mode("error")`, then captured into a CUDA graph and
    replayed on new contexts: the eager result on those contexts."""
    from repro_torch.core.attention import backend as TB

    q, kp, pt, cl = _mla_case(cuda, torch.bfloat16,
                              (128, 512, 64, 16, [300, 0, 2048, 17], None))
    cl2 = torch.tensor([5, 1000, 0, 2000], dtype=torch.int32, device=cuda)
    kp5 = kp[None, None]
    torch.cuda.set_sync_debug_mode("error")
    try:
        want = TB.mla_decode_attention(q, kp5, pt, cl2, v_dim=512,
                                       scale=0.1)
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            TB.mla_decode_attention(q, kp5, pt, cl, v_dim=512, scale=0.1)
        torch.cuda.current_stream().wait_stream(s)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = TB.mla_decode_attention(q, kp5, pt, cl, v_dim=512,
                                          scale=0.1)
        cl.copy_(cl2)
        graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


MLA_FLASH_CASES = [  # B, S, H, kv_len
    (3, 40, 4, [40, 17, 0]),  # ragged rows, one dead
    (2, 130, 2, [130, 65]),  # three 64-key tiles, a ragged last one
    (1, 64, 128, [50]),  # deepseek-v2's 128 heads
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", MLA_FLASH_CASES)
def test_flash_mla_widths_match_plain(cuda, dtype, case):
    """Key width 192 / value width 128 with a per-batch kv_len: the
    tensor-core kernel in bf16, the scalar one in fp32, against the plain
    version; rows of a slice with kv_len 0 are exact zeros."""
    b, s, h, kvl = case
    g = torch.Generator().manual_seed(5)
    q, k = (torch.randn((b, s, h, 192), generator=g).to(dtype)
            for _ in range(2))
    v = torch.randn((b, s, h, 128), generator=g).to(dtype)
    kv_len = torch.tensor(kvl, dtype=torch.int32)
    bq = fops.pick_block_q(s, 1)
    qp = fops.pack_q(q, h).reshape(b * h, s // bq, bq, 192).contiguous()
    kp, vp = (x.permute(0, 2, 1, 3).reshape(b * h, s, x.shape[3])
              .contiguous() for x in (k, v))
    kvh = kv_len.repeat_interleave(h)
    kw = dict(block_q=bq, group=1, scale=192 ** -0.5, causal=True,
              q_offset=0)
    n0 = FK.LAUNCHES["flash_attention_fwd"]
    o, lse = FK.flash_attention_fwd(qp.to(cuda), kp.to(cuda), vp.to(cuda),
                                    kv_len=kvh.to(cuda), **kw)
    want_o, want_lse = FK.flash_attention_fwd_plain(qp, kp, vp, kv_len=kvh,
                                                    **kw)
    torch.cuda.synchronize()
    assert FK.LAUNCHES["flash_attention_fwd"] == n0 + 1
    assert o.shape == (b * h, s // bq, bq, 128)
    torch.testing.assert_close(o.cpu().float(), want_o.float(),
                               atol=ATOL[dtype], rtol=0)
    torch.testing.assert_close(lse.cpu(), want_lse, atol=1e-4, rtol=0)
    dead = (kvh == 0).to(cuda)
    assert not o[dead].any()


MLA_TRAIN_FLASH_CASES = [  # B, S, H: MLA's training forward, no kv_len
    (2, 130, 2),  # three 64-key tiles, a ragged last one
    (1, 256, 128),  # deepseek-v2's 128 heads
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", MLA_TRAIN_FLASH_CASES)
def test_flash_mla_train_widths_match_plain(cuda, dtype, case):
    """Key width 192 / value width 128 without kv_len (the training
    path's instance, `flash_mma_kernel<192, 128, false>` in bf16; the
    scalar kernel in fp32) against the plain version."""
    b, s, h = case
    g = torch.Generator().manual_seed(6)
    q, k = (torch.randn((b, s, h, 192), generator=g).to(dtype)
            for _ in range(2))
    v = torch.randn((b, s, h, 128), generator=g).to(dtype)
    bq = fops.pick_block_q(s, 1)
    qp = fops.pack_q(q, h).reshape(b * h, s // bq, bq, 192).contiguous()
    kp, vp = (x.permute(0, 2, 1, 3).reshape(b * h, s, x.shape[3])
              .contiguous() for x in (k, v))
    kw = dict(block_q=bq, group=1, scale=192 ** -0.5, causal=True,
              q_offset=0)
    kernel = "flash_mma_kernel" if dtype == torch.bfloat16 \
        else "flash_fwd_kernel"
    n0 = FK.KERNEL_LAUNCHES[kernel]
    o, lse = FK.flash_attention_fwd(qp.to(cuda), kp.to(cuda), vp.to(cuda),
                                    **kw)
    want_o, want_lse = FK.flash_attention_fwd_plain(qp, kp, vp, **kw)
    torch.cuda.synchronize()
    assert FK.KERNEL_LAUNCHES[kernel] == n0 + 1
    torch.testing.assert_close(o.cpu().float(), want_o.float(),
                               atol=ATOL[dtype], rtol=0)
    torch.testing.assert_close(lse.cpu(), want_lse, atol=1e-4, rtol=0)


@pytest.mark.parametrize("kv_len", [None, [100, 256]])
@pytest.mark.parametrize("group", [1, 2])
def test_flash_mixed_width_gradient_on_card_matches_cpu(cuda, kv_len,
                                                        group):
    """192 / 128 in fp32: autograd through the kernel's forward and the
    recompute backward (with the kv_len mask) on the card against the
    same on the CPU (the plain forward)."""
    b, s, hkv = 2, 256, 4
    g = torch.Generator().manual_seed(7)
    inputs = [torch.randn((b, s, hkv * group, 192), generator=g),
              torch.randn((b, s, hkv, 192), generator=g),
              torch.randn((b, s, hkv, 128), generator=g)]
    w = torch.randn((b, s, hkv * group, 128), generator=g)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        xs = [x.to(dev).requires_grad_(True) for x in inputs]
        kvl = None if kv_len is None else torch.tensor(
            kv_len, dtype=torch.int32, device=dev)
        out = fops.flash_attention(*xs, causal=True, kv_len=kvl)
        torch.sum(out * w.to(dev)).backward()
        grads.append([x.grad.cpu() for x in xs])
    for a, c in zip(*grads):
        torch.testing.assert_close(a, c, atol=1e-4, rtol=0)


@pytest.mark.parametrize("shape", [(128, 8, 128, 512), (128, 64, 512, 128)])
def test_mla_absorbed_products_sum_in_fp32(cuda, shape):
    """The decode's q_abs / wv_b products at deepseek-v2's widths: bf16
    operands on the card (a bf16 GEMM with fp32 output, weights
    transposed views as the layer passes them) give the fp32 products
    and sums of the CPU's fp64 product to fp32 rounding."""
    from repro_torch.models.attention import _bmm_f32

    n, i, k, j = shape
    g = torch.Generator().manual_seed(7)
    a = torch.randn((i, n, k), generator=g).to(torch.bfloat16)
    w = torch.randn((k, n, j), generator=g).to(torch.bfloat16)
    got = _bmm_f32(a.to(cuda).transpose(0, 1), w.to(cuda).transpose(0, 1))
    want = torch.bmm(a.double().transpose(0, 1), w.double().transpose(0, 1))
    assert got.dtype == torch.float32 and got.shape == (n, i, j)
    torch.testing.assert_close(got.cpu().double(), want, atol=1e-4,
                               rtol=1e-5)


def test_mla_engine_on_card_matches_cpu(cuda):
    """Reduced deepseek-v2 in fp32 (the scalar flash and latent decode
    kernels), the card model a copy of the CPU one, on the padded step,
    graphs and eager: greedy tokens equal the plain versions'; every
    decode step one latent decode launch a layer."""
    import copy

    cfg = reduced(ARCHS["deepseek-v2-236b"]).replace(dtype="float32")
    model = weights.init_random(cfg, 0, device="cpu")
    card = copy.deepcopy(model).to(cuda)
    outs = []
    for dev, m, graphs in ((cuda, card, True), (cuda, card, False),
                           (torch.device("cpu"), model, False)):
        AK.reset_launches()
        eng = Engine(cfg, m, max_seqs=4, num_pages=64, max_model_len=256,
                     device=dev, cuda_graphs=graphs)
        reqs = eng.generate([Request(prompt=p, max_new_tokens=6) for p in
                             _prompts_for("deepseek-v2-236b",
                                          (5, 40, 17, 70), 4)])
        outs.append([r.output for r in reqs])
        if dev.type == "cuda":
            assert AK.LAUNCHES["mla_decode"] == \
                cfg.num_layers * eng.device_calls["decode"]
    assert outs[0] == outs[1] == outs[2]


def _trainable_case(which, dev, dtype, seed=40):
    """(the Function, the forward op it wraps, inputs, a cotangent) at a
    two-chunk shape: the SSD (B 2, L 256, H 4, P 128, N 64, G 1, chunk
    128) or the mLSTM (B 2, L 128, H 2, P 64, chunk 64), from the zero
    state."""
    if which == "ssd":
        case = (2, 256, 4, 128, 64, 1, 128)
        args = _ssd_inputs(dev, dtype, case, seed=seed)[:6]
        fn = lambda *t: sops.mamba2_ssd_trainable(*t, chunk=128)  # noqa
        op = lambda *t: sops.mamba2_ssd(*t, chunk=128)[0]  # noqa: E731
    else:
        case = (2, 128, 2, 64, 64)
        args = _mlstm_inputs(dev, dtype, case, state=False, seed=seed)[:5]
        fn = lambda *t: mops.mlstm_trainable(*t, chunk=64)  # noqa: E731
        op = lambda *t: mops.mlstm_chunked(*t, chunk=64)[0]  # noqa: E731
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(args[0].shape, generator=g).to(dev)
    return fn, op, args, w


@pytest.mark.parametrize("which", ["ssd", "mlstm"])
def test_trainable_gradient_on_card_matches_cpu(cuda, which):
    """The Function (kernel forward, recompute backward) on the card
    against the same on the CPU, fp32 with TF32 off: every input's
    gradient within 1e-4 x its largest element."""
    grads = []
    for dev in (cuda, torch.device("cpu")):
        fn, _, args, w = _trainable_case(which, "cpu", torch.float32)
        xs = [t.to(dev).requires_grad_(True) for t in args]
        (fn(*xs) * w.to(dev)).sum().backward()
        grads.append([x.grad.cpu() for x in xs])
    for i, (a, b) in enumerate(zip(*grads)):
        assert torch.isfinite(a).all(), i
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()),
                                   msg=f"{which} input {i}")


@pytest.mark.parametrize("which", ["ssd", "mlstm"])
def test_trainable_bf16_forward_is_the_op_one_launch(cuda, which):
    """In bf16 the Function's forward is the op bit for bit (the
    tensor-core kernel), one launch a forward and none in the backward."""
    fn, op, args, w = _trainable_case(which, cuda, torch.bfloat16)
    mod, kern = (SK, "ssd_mma_kernel") if which == "ssd" else \
        (MK, "mlstm_mma_kernel")
    want = op(*args)
    xs = [t.clone().requires_grad_(True) for t in args]
    mod.reset_launches()
    got = fn(*xs)
    torch.cuda.synchronize()
    assert mod.KERNEL_LAUNCHES[kern] == 1
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    (got.float() * w).sum().backward()
    torch.cuda.synchronize()
    assert sum(mod.KERNEL_LAUNCHES.values()) == 1
    assert all(x.grad is not None and x.grad.dtype == x.dtype
               and torch.isfinite(x.grad.float()).all() for x in xs)


# ---------------------------------------------------------------------------
# the packed step's per-layer glue (csrc/layer_glue.cu): each kernel against
# its plain version.  The norm sums the squares in another order (fp32:
# within (d / 2 + 4) ulps of each value; bf16: one ulp); the rotation, the
# page write and the gate round where the plain ops round (q and the pages
# bit for bit in fp32, the pages in bf16 too; bf16 q and h within one ulp).
# ---------------------------------------------------------------------------

GLUE_NORM_WIDTHS = [576, 1536, 16384, 100]  # 100: the one-element path
# Hq, Hkv, D, style (M-RoPE at qwen2-vl-2b's sections)
GLUE_ROPE_CASES = [(9, 3, 64, "rope"), (12, 2, 128, "mrope"),
                   (32, 32, 64, "none"), (4, 4, 256, "rope")]
GLUE_POOL = (8, 16)  # pages, page size


def _ulps(x, dtype, n=1):
    """n ulps of dtype at each element's magnitude."""
    mant = 7 if dtype == torch.bfloat16 else 23
    a = x.float().abs().clamp_min(2.0 ** -126)
    return n * torch.exp2(torch.floor(torch.log2(a)) - mant)


def _rope_case(dev, dtype, case, seed=0):
    hq, hkv, d, style = case
    g = torch.Generator().manual_seed(seed)
    t = 11
    pages, ps = GLUE_POOL
    spp = pages * ps
    slots = torch.randperm(spp - ps, generator=g)[:t] + ps
    # a dead row (the trash slot), a slot from the pool's end, one below
    slots[0], slots[1], slots[2] = spp, slots[1] - spp, -spp - 1
    pos = torch.randint(0, 4096, (t,), generator=g)
    pos[3], pos[4] = 99991, 100000
    positions = torch.stack([pos, pos.flip(0), pos // 3]) \
        if style == "mrope" else pos
    qkv = torch.randn(t, (hq + 2 * hkv) * d, generator=g).to(dev, dtype)
    q, k, v = (a.view(t, -1, d) for a in qkv.split(
        [hq * d, hkv * d, hkv * d], dim=-1))
    rope = style != "none"
    args = (q, k, v, positions.to(dev) if rope else None,
            TL.rope_frequencies(d, 1e6, dev) if rope else None)
    kv = torch.randn(2, hkv, 1, pages, ps, d, generator=g).to(dev, dtype)
    return args, kv, write_index(slots[None].to(dev), spp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", GLUE_NORM_WIDTHS)
@pytest.mark.parametrize("add", [True, False])
def test_add_rms_norm_kernel_matches_plain(cuda, dtype, d, add):
    g = torch.Generator().manual_seed(d)
    x = torch.randn(1, 9, d, generator=g).to(cuda, dtype)
    delta = (torch.randn(1, 9, d, generator=g) * 2).to(cuda, dtype) \
        if add else None
    scale = (1 + 0.1 * torch.randn(d, generator=g)).to(cuda, dtype)
    GL.reset_launches()
    h, x_new = GL.add_rms_norm(x, delta, scale, 1e-5)
    hp, xp = GL.add_rms_norm_plain(x, delta, scale, 1e-5)
    torch.cuda.synchronize()
    assert GL.KERNEL_LAUNCHES["add_rms_norm_kernel"] == 1
    assert torch.equal(x_new, xp) and (add or x_new is x)
    bound = _ulps(hp, dtype) if dtype == torch.bfloat16 \
        else _ulps(hp, dtype, d / 2 + 4)
    assert bool(((h.float() - hp.float()).abs() <= bound).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GLUE_ROPE_CASES)
def test_rope_write_kv_kernel_matches_plain(cuda, dtype, case):
    args, kv, index = _rope_case(cuda, dtype, case)
    kv_plain = kv.clone()
    kw = dict(style=case[3], sections=(16, 24, 24))
    GL.reset_launches()
    q_rot = GL.rope_write_kv(*args, kv[0], kv[1], index, **kw)
    q_plain = GL.rope_write_kv_plain(*args, kv_plain[0], kv_plain[1], index,
                                     **kw)
    torch.cuda.synchronize()
    assert GL.KERNEL_LAUNCHES["rope_write_kv_kernel"] == 1
    assert torch.equal(kv, kv_plain)
    if dtype == torch.float32:
        assert torch.equal(q_rot, q_plain)
    else:
        assert bool(((q_rot.float() - q_plain.float()).abs()
                     <= _ulps(q_plain, dtype)).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ff", [1536, 8960, 37])  # 37: the one-element path
@pytest.mark.parametrize("fused", [True, False])
def test_silu_mul_kernel_matches_plain(cuda, dtype, ff, fused):
    g = torch.Generator().manual_seed(ff)
    gu = (torch.randn(1, 13, 2 * ff, generator=g) * 4).to(cuda, dtype)
    gate, up = gu.chunk(2, dim=-1)
    if not fused:
        gate, up = gate.contiguous(), up.contiguous()
    GL.reset_launches()
    h = GL.silu_mul(gate, up)
    hp = GL.silu_mul_plain(gate, up)
    torch.cuda.synchronize()
    assert GL.KERNEL_LAUNCHES["silu_mul_kernel"] == 1
    assert h.is_contiguous() and h.shape == hp.shape
    assert bool(((h.float() - hp.float()).abs()
                 <= _ulps(hp, dtype, 1 if dtype == torch.bfloat16 else 2))
                .all())


def test_glue_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros(64, 8, device=cuda).t()  # not contiguous
    with pytest.raises(ValueError):
        GL.add_rms_norm(x, None, torch.ones(64, device=cuda), 1e-5)
    with pytest.raises(ValueError):  # no unit element stride
        GL.silu_mul(x, x)
    args, kv, index = _rope_case(cuda, torch.float32, GLUE_ROPE_CASES[0])
    q, k, v, pos, freqs = args
    with pytest.raises(ValueError):  # heads not D contiguous elements
        GL.rope_write_kv(q.transpose(0, 1).contiguous().transpose(0, 1), k,
                         v, pos, freqs, kv[0], kv[1], index, style="rope")
    with pytest.raises(ValueError):  # pages not contiguous
        GL.rope_write_kv(q, k, v, pos, freqs, kv[0].transpose(3, 4),
                         kv[1], index, style="rope")


def test_glue_kernels_capture_into_a_graph(cuda):
    """The three launches captured into a CUDA graph: a replay gives the
    eager call's outputs and pages (no host read, no allocation outside
    PyTorch's allocator)."""
    dtype = torch.bfloat16
    g = torch.Generator().manual_seed(5)
    x = torch.randn(1, 8, 576, generator=g).to(cuda, dtype)
    delta = torch.randn(1, 8, 576, generator=g).to(cuda, dtype)
    scale = torch.ones(576, device=cuda, dtype=dtype)
    gu = torch.randn(1, 8, 3072, generator=g).to(cuda, dtype)
    args, kv, index = _rope_case(cuda, dtype, GLUE_ROPE_CASES[0])

    def body():
        h, x_new = GL.add_rms_norm(x, delta, scale, 1e-5)
        q = GL.rope_write_kv(*args, kv[0], kv[1], index, style="rope")
        return h, x_new, q, GL.silu_mul(*gu.chunk(2, dim=-1))

    kv_before = kv.clone()
    want = [t.clone() for t in body()]
    kv_want = kv.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = body()
    kv.copy_(kv_before)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(outs, want))
    assert torch.equal(kv, kv_want) and not torch.equal(kv, kv_before)


# ---------------------------------------------------------------------------
# the optimizer step (csrc/optimizer.cu): AdamW bit for bit against its
# plain version in every (parameter, gradient) dtype pair; the sum of
# squares within SUMSQ_RTOL of the plain sums (another order: a sum of
# positive fp32 terms added in a chain k deep lies within k x 2^-24 of the
# exact sum, and neither side's chains here reach 512) and bit for bit
# across launches.
# ---------------------------------------------------------------------------

SUMSQ_RTOL = 1024 * 2.0 ** -24
# odd sizes, a tensor over several of sum_squares_kernel's chunks, an
# empty one
OPT_SHAPES = [(7, 5), (3,), (129, 67), (1,), (3 * (1 << 18) + 77,), (0,),
              (4096,)]


def _views(dev, dtype, shapes, g, offset=0, scale=1.0):
    """Seeded tensors of `shapes`, each a contiguous view `offset`
    elements into a flat buffer of its own (offset 1: no 16-byte start)."""
    out = []
    for s in shapes:
        n = int(np.prod(s))
        buf = (torch.randn(n + offset, generator=g) * scale).to(dev, dtype)
        out.append(buf[offset:].view(s))
    return out


@pytest.mark.parametrize("pair", [(torch.bfloat16, torch.bfloat16),
                                  (torch.float32, torch.float32),
                                  (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("offsets", [(0, 0), (1, 1), (1, 2)])
def test_adamw_kernel_matches_plain_bit_for_bit(cuda, pair, offsets):
    """p, mu and nu bit for bit after two updates (counts 1 and 4, the
    clip active), aligned, with every tensor a view one element in (the
    scalar head and tail), and with the moments at another offset than p
    and g (the scalar path); one tensor's gradient is zero (a parameter
    the loss does not reach)."""
    from repro_torch.kernels.optimizer import kernel as OK

    pd, gd = pair
    g = torch.Generator().manual_seed(34)
    po, mo = offsets
    params = _views(cuda, pd, OPT_SHAPES, g, po)
    grads = _views(cuda, gd, OPT_SHAPES, g, po, 3.0)
    grads[1].zero_()
    mus = _views(cuda, torch.float32, OPT_SHAPES, g, mo, 0.1)
    nus = [x.abs() for x in _views(cuda, torch.float32, OPT_SHAPES, g, mo,
                                   0.1)]
    copies = [[x.clone() for x in xs] for xs in (params, mus, nus)]
    sums = OK.sum_squares_plain(grads)
    for count in (1, 4):
        scale = torch.clamp(1.0 / torch.clamp(torch.sqrt(torch.sum(sums)),
                                              min=1e-9), max=1.0)
        cf = torch.tensor(float(count), device=cuda)
        kw = dict(scale=scale, bc1=1 - 0.9 ** cf, bc2=1 - 0.95 ** cf,
                  lr=torch.tensor(3e-3, device=cuda), b1=0.9, b2=0.95,
                  eps=1e-8, weight_decay=0.1)
        OK.reset_launches()
        OK.adamw(params, grads, mus, nus, **kw)
        OK.adamw_plain(copies[0], grads, copies[1], copies[2], **kw)
        torch.cuda.synchronize()
        assert OK.KERNEL_LAUNCHES == {"sum_squares_kernel": 0,
                                      "adamw_kernel": 1}
        for got, want in zip(params + mus + nus, sum(copies, [])):
            assert got.dtype == want.dtype and torch.equal(got, want)
    assert float(scale) < 1.0


def test_adamw_kernel_groups_and_scalars(cuda):
    """A list of all three dtype pairs launches once per pair; a Python
    float lr and a 0-d device lr give the same bits."""
    from repro_torch.kernels.optimizer import kernel as OK

    g = torch.Generator().manual_seed(35)
    pairs = [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
             (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)]
    shapes = [(33, 7)] * 4

    def state():
        g.manual_seed(35)
        ps = [_views(cuda, pd, [s], g)[0]
              for (pd, _), s in zip(pairs, shapes)]
        gs = [_views(cuda, gd, [s], g)[0]
              for (_, gd), s in zip(pairs, shapes)]
        ms = _views(cuda, torch.float32, shapes, g, scale=0.1)
        ns = [x.abs() for x in _views(cuda, torch.float32, shapes, g,
                                      scale=0.1)]
        return ps, gs, ms, ns

    kw = dict(scale=torch.tensor(0.5, device=cuda),
              bc1=torch.tensor(0.1, device=cuda),
              bc2=torch.tensor(0.05, device=cuda), b1=0.9, b2=0.95, eps=1e-8,
              weight_decay=0.1)
    a, b = state(), state()
    OK.reset_launches()
    OK.adamw(*a, lr=3e-3, **kw)
    assert OK.KERNEL_LAUNCHES["adamw_kernel"] == 3
    OK.adamw(*b, lr=torch.tensor(3e-3, device=cuda), **kw)
    torch.cuda.synchronize()
    for x, y in zip(sum(a, []), sum(b, [])):
        assert torch.equal(x, y)


@pytest.mark.parametrize("offset", [0, 1])
def test_sum_squares_kernel_matches_plain_and_is_deterministic(cuda, offset):
    from repro_torch.kernels.optimizer import kernel as OK

    g = torch.Generator().manual_seed(36)
    xs = [t for i, s in enumerate(OPT_SHAPES)
          for t in _views(cuda, torch.bfloat16 if i % 2 else torch.float32,
                          [s], g, offset, 4.0)]
    xs.append(torch.zeros(300, device=cuda))
    OK.reset_launches()
    got = OK.sum_squares(xs)
    again = OK.sum_squares(xs)
    want = OK.sum_squares_plain(xs)
    torch.cuda.synchronize()
    assert OK.KERNEL_LAUNCHES == {"sum_squares_kernel": 2, "adamw_kernel": 0}
    assert got.shape == (len(xs),) and torch.equal(got, again)
    assert bool(((got - want).abs() <= SUMSQ_RTOL * want).all())
    assert float(got[OPT_SHAPES.index((0,))]) == 0.0 and float(got[-1]) == 0.0


@pytest.mark.parametrize("pair", [(torch.bfloat16, torch.bfloat16),
                                  (torch.float32, torch.float32),
                                  (torch.bfloat16, torch.float32)])
def test_optimizer_kernels_on_a_long_list(cuda, pair):
    """A list as long as a model's (300 tensors, ~37 rows for each warp of
    sum_squares_kernel's last block, adamw_kernel's row search over all of
    them): mostly small odd sizes, every 23rd tensor over several chunks
    of both kernels, a few empty, every 7th a view one element in.  AdamW
    bit for bit, the sums within SUMSQ_RTOL and deterministic."""
    from repro_torch.kernels.optimizer import kernel as OK

    pd, gd = pair
    rng = np.random.default_rng(37)
    shapes = [(0,) if i % 61 == 60 else
              (3 * OK.SUM_CHUNK + int(rng.integers(1, 999)),) if i % 23 == 5
              else (int(rng.integers(1, 5000)),) for i in range(300)]
    g = torch.Generator().manual_seed(37)

    def make(dtype, scale):
        return [_views(cuda, dtype, [s], g, int(i % 7 == 3), scale)[0]
                for i, s in enumerate(shapes)]

    params, grads, mus = make(pd, 1.0), make(gd, 3.0), make(torch.float32,
                                                            0.1)
    nus = [x.abs() for x in make(torch.float32, 0.1)]
    grads[2].zero_()
    copies = [[x.clone() for x in xs] for xs in (params, mus, nus)]
    OK.reset_launches()
    sums, again = OK.sum_squares(grads), OK.sum_squares(grads)
    want = OK.sum_squares_plain(grads)
    scale = torch.clamp(1.0 / torch.clamp(torch.sqrt(torch.sum(sums)),
                                          min=1e-9), max=1.0)
    cf = torch.tensor(3.0, device=cuda)
    kw = dict(scale=scale, bc1=1 - 0.9 ** cf, bc2=1 - 0.95 ** cf,
              lr=torch.tensor(3e-3, device=cuda), b1=0.9, b2=0.95, eps=1e-8,
              weight_decay=0.1)
    OK.adamw(params, grads, mus, nus, **kw)
    OK.adamw_plain(copies[0], grads, copies[1], copies[2], **kw)
    torch.cuda.synchronize()
    assert OK.KERNEL_LAUNCHES == {"sum_squares_kernel": 2, "adamw_kernel": 1}
    assert torch.equal(sums, again)
    assert bool(((sums - want).abs() <= SUMSQ_RTOL * want).all())
    assert float(sums[2]) == 0.0 and float(scale) < 1.0
    for got, ref in zip(params + mus + nus, sum(copies, [])):
        assert got.dtype == ref.dtype and torch.equal(got, ref)
