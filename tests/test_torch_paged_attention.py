"""The port's paged-attention plain versions and host layer against the
JAX Pallas kernels (interpret mode on the CPU) on identical numpy inputs.

Tolerance: fp32 atol = rtol = 1e-5 — the two sides sum the dot products
and the softmax in different orders; everything else (masking constant,
m_safe guard, l == 0 -> 1) is the same arithmetic, so dead rows, blocks
and segments must be exact zeros on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import kernel as JK
from repro.kernels.paged_attention import ops as jops
from repro_torch.core.paged.kv_cache import ShardingError
from repro_torch.kernels._common import NEG_INF
from repro_torch.kernels.paged_attention import kernel as TK
from repro_torch.kernels.paged_attention import ops as tops

TOL = dict(atol=1e-5, rtol=1e-5)


def make_case(seed, s, hq, hkv, d, ps, np_):
    rng = np.random.default_rng(seed)
    p = s * np_ + 1
    q = rng.standard_normal((s, hq, d)).astype(np.float32)
    kp = rng.standard_normal((hkv, p, ps, d)).astype(np.float32)
    vp = rng.standard_normal((hkv, p, ps, d)).astype(np.float32)
    pt = (rng.permutation(p - 1)[: s * np_].reshape(s, np_) + 1).astype(
        np.int32)
    return q, kp, vp, pt


def tview(a, tile, lib):
    hkv, p, ps, d = a.shape
    shape = (hkv, p, ps // tile, tile, d)
    return jnp.asarray(a).reshape(shape) if lib == "jax" \
        else torch.from_numpy(a).reshape(shape)


def t(a):
    return torch.from_numpy(np.array(a))


# (hq, hkv, ps, tile, pages_per_seq, context_lens, head_dim): group 1/2/3,
# page 16 with tiles 8/16, non-power-of-two page 24 with tiles 8/24,
# ragged contexts with ctx = 0 rows; then the shapes the card holds the
# streaming decode kernels to: D 128 at group 8 (qwen2.5-3b) and 16
# (glm4-9b), group 1 over 8 KV heads (zamba2's decode), and contexts that
# end on a page (32) and on a segment boundary (at 4 segments of 2 tiles
# of 8: 16 keys a segment, 48)
CASES = [
    (2, 2, 16, 8, 4, [37, 0, 64, 1], 64),
    (4, 2, 16, 16, 4, [0, 13, 50, 64], 64),
    (3, 1, 24, 8, 3, [72, 5, 0, 30], 64),
    (6, 2, 24, 24, 3, [49, 0, 24, 1], 64),
    (16, 2, 16, 16, 3, [33, 0, 48, 1], 128),
    (32, 2, 16, 16, 2, [17, 32, 0], 128),
    (8, 8, 16, 16, 3, [40, 1, 0, 48], 64),
    (6, 2, 16, 8, 4, [48, 32, 0, 64], 64),
]
SEG_CASES = CASES[1:3] + CASES[4:]


@pytest.mark.parametrize("variant", ["gqa", "baseline"])
@pytest.mark.parametrize("case", CASES)
def test_paged_decode_plain_matches_pallas(variant, case):
    hq, hkv, ps, tile, np_, ctx, d = case
    s = len(ctx)
    group = hq // hkv
    q, kp, vp, pt = make_case(1, s, hq, hkv, d, ps, np_)
    ctx = np.asarray(ctx, np.int32)
    tpp = ps // tile
    if variant == "gqa":
        qq, m, head = q.reshape(s, hkv, group, d), group, (lambda h: h)
        cells_per_kv = 1
    else:
        qq, m = q.reshape(s, hq, 1, d), 1
        head = lambda h: jax.lax.div(h, jnp.int32(group))  # noqa: E731
        cells_per_kv = group
    want = JK.paged_decode(
        jnp.asarray(qq), tview(kp, tile, "jax"), tview(vp, tile, "jax"),
        jnp.asarray(pt), jnp.asarray(ctx), tile=tile, tiles_per_page=tpp,
        num_tiles=np_ * tpp, kv_head_of_cell=head, scale=d ** -0.5,
        interpret=True)
    got = TK.paged_decode(
        t(qq), tview(kp, tile, "torch"), tview(vp, tile, "torch"), t(pt),
        t(ctx), cells_per_kv=cells_per_kv, scale=d ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    dead = ctx == 0
    assert (got.numpy()[dead] == 0).all() and m >= 1


@pytest.mark.parametrize("nseg", [1, 3, 4, 8])
@pytest.mark.parametrize("case", SEG_CASES)
def test_segmented_and_reduce_plain_match_pallas(nseg, case):
    """nseg = 8 exceeds the live tiles of every short row (dead segments
    must give exact (acc 0, m NEG_INF, l 0) in the partials)."""
    hq, hkv, ps, tile, np_, ctx, d = case
    s = len(ctx)
    group = hq // hkv
    q, kp, vp, pt = make_case(2, s, hq, hkv, d, ps, np_)
    ctx = np.asarray(ctx, np.int32)
    tpp = ps // tile
    num_tiles = np_ * tpp
    nseg = min(nseg, num_tiles)
    tps = -(-num_tiles // nseg)
    qq = q.reshape(s, hkv, group, d)
    want = JK.paged_decode_segmented(
        jnp.asarray(qq), tview(kp, tile, "jax"), tview(vp, tile, "jax"),
        jnp.asarray(pt), jnp.asarray(ctx), tile=tile, tiles_per_page=tpp,
        num_segments=nseg, tiles_per_segment=tps, scale=d ** -0.5,
        interpret=True)
    got = TK.paged_decode_segmented(
        t(qq), tview(kp, tile, "torch"), tview(vp, tile, "torch"), t(pt),
        t(ctx), num_segments=nseg, tiles_per_segment=tps, scale=d ** -0.5)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    live_tiles = -(-ctx // tile)
    for si in range(s):
        for gi in range(nseg):
            if gi * tps >= live_tiles[si]:  # dead segment
                assert (got[0][si, :, gi] == 0).all()
                assert (got[1][si, :, gi] == NEG_INF).all()
                assert (got[2][si, :, gi] == 0).all()
    # the merge, on the Pallas partials
    red_want = JK.segment_reduce(*want, jnp.float32, interpret=True)
    red_got = TK.segment_reduce(*(t(w) for w in want), torch.float32)
    np.testing.assert_allclose(red_got.numpy(), np.asarray(red_want), **TOL)
    assert (red_got.numpy()[ctx == 0] == 0).all()


@pytest.mark.parametrize("nseg", [1, 3, 4, 8])
@pytest.mark.parametrize("case", SEG_CASES)
def test_segmented_merged_plain_matches_pallas(nseg, case):
    """C3 in one call (the serving path's form) against the Pallas
    segmented kernel followed by the Pallas merge."""
    hq, hkv, ps, tile, np_, ctx, d = case
    s = len(ctx)
    q, kp, vp, pt = make_case(9, s, hq, hkv, d, ps, np_)
    ctx = np.asarray(ctx, np.int32)
    tpp = ps // tile
    num_tiles = np_ * tpp
    nseg = min(nseg, num_tiles)
    tps = -(-num_tiles // nseg)
    qq = q.reshape(s, hkv, hq // hkv, d)
    parts = JK.paged_decode_segmented(
        jnp.asarray(qq), tview(kp, tile, "jax"), tview(vp, tile, "jax"),
        jnp.asarray(pt), jnp.asarray(ctx), tile=tile, tiles_per_page=tpp,
        num_segments=nseg, tiles_per_segment=tps, scale=d ** -0.5,
        interpret=True)
    want = JK.segment_reduce(*parts, jnp.float32, interpret=True)
    got = TK.paged_decode_segmented_merged(
        t(qq), tview(kp, tile, "torch"), tview(vp, tile, "torch"), t(pt),
        t(ctx), num_segments=nseg, tiles_per_segment=tps, scale=d ** -0.5)
    assert got.dtype == torch.float32 and got.shape == qq.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (ctx == 0).any() and (got.numpy()[ctx == 0] == 0).all()


def _ragged(seed, ctx, qlens, hq, hkv, ps, np_, d=64):
    """A packed prefill batch: each sequence's chunk of qlens[i] tokens at
    positions ctx[i]-qlens[i] .. ctx[i]-1, back to back, then 3 padded
    tail rows."""
    s = len(ctx)
    q, kp, vp, pt = make_case(seed, s, hq, hkv, d, ps, np_)
    qlens = np.asarray(qlens, np.int32)
    qsl = np.concatenate([[0], np.cumsum(qlens)]).astype(np.int32)
    total = int(qsl[-1])
    rng = np.random.default_rng(seed + 100)
    qt = rng.standard_normal((total + 3, hq, d)).astype(np.float32)
    return qt, kp, vp, pt, np.asarray(ctx, np.int32), qsl, qlens


# resumed chunks (ctx > qlen), fresh chunks (ctx == qlen), an empty slot
PREFILL_CASES = [
    # hq, hkv, ps, tile, np_, ctx, qlens, block_q
    (2, 1, 16, 16, 6, [40, 17, 0, 90], [40, 5, 0, 33], 16),
    (6, 2, 24, 8, 4, [24, 70, 9], [7, 70, 9], 8),
    (3, 3, 16, 8, 4, [64, 3], [20, 3], 16),
]


# the shapes the bf16 tensor-core prefill is held to on the card: qwen2.5-3b's
# heads (group 8, D 128) with 128 rows a Q-Block, page 24, an empty slot;
# group 1 with Q-blocks of four sequences back to back
MMA_PREFILL_CASES = [
    # hq, hkv, ps, tile, np_, ctx, qlens, block_q, d
    (16, 2, 24, 24, 4, [0, 70, 37], [0, 41, 37], 16, 128),
    (4, 4, 16, 16, 4, [50, 17, 40, 3], [50, 17, 40, 3], 16, 64),
]


@pytest.mark.parametrize("case", PREFILL_CASES)
def test_prefill_qblock_plain_matches_pallas(case):
    _prefill_vs_pallas(*case, d=64)


@pytest.mark.parametrize("case", MMA_PREFILL_CASES)
def test_prefill_qblock_plain_matches_pallas_at_tensor_core_shapes(case):
    _prefill_vs_pallas(*case)


def _prefill_vs_pallas(hq, hkv, ps, tile, np_, ctx, qlens, block_q, d):
    group = hq // hkv
    qt, kp, vp, pt, ctx, qsl, qlens = _ragged(3, ctx, qlens, hq, hkv, ps, np_,
                                              d=d)
    nqb = qt.shape[0] // block_q + len(ctx) + 1  # static max: dead blocks
    meta = jops.build_qblock_metadata(
        jnp.asarray(qsl), jnp.asarray(qlens), jnp.asarray(ctx),
        block_q=block_q, num_q_blocks=nqb)
    qb_seq, qb_pos0 = (np.asarray(a) for a in meta[:2])
    assert (qb_seq < 0).any()
    rng = np.random.default_rng(4)
    qp = rng.standard_normal((nqb, hkv, block_q * group, d)).astype(np.float32)
    tpp = ps // tile
    want = JK.paged_prefill_qblock(
        jnp.asarray(qp), tview(kp, tile, "jax"), tview(vp, tile, "jax"),
        jnp.asarray(qb_seq), jnp.asarray(qb_pos0), jnp.asarray(pt),
        jnp.asarray(ctx), tile=tile, tiles_per_page=tpp,
        num_kv_tiles=np_ * tpp, block_q=block_q, group=group,
        scale=d ** -0.5, interpret=True)
    got = TK.paged_prefill_qblock(
        t(qp), tview(kp, tile, "torch"), tview(vp, tile, "torch"),
        t(qb_seq), t(qb_pos0), t(pt), t(ctx), block_q=block_q, group=group,
        scale=d ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got.numpy()[qb_seq < 0] == 0).all()


@pytest.mark.parametrize("case", PREFILL_CASES)
def test_build_qblock_metadata_matches_exactly(case):
    _, _, _, _, _, ctx, qlens, block_q = case
    qlens = np.asarray(qlens, np.int32)
    qsl = np.concatenate([[0], np.cumsum(qlens)]).astype(np.int32)
    ctx = np.asarray(ctx, np.int32)
    nqb = int(qsl[-1]) // block_q + len(ctx) + 2
    want = jops.build_qblock_metadata(
        jnp.asarray(qsl), jnp.asarray(qlens), jnp.asarray(ctx),
        block_q=block_q, num_q_blocks=nqb)
    got = tops.build_qblock_metadata(t(qsl), t(qlens), t(ctx),
                                     block_q=block_q, num_q_blocks=nqb)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("variant", ["baseline", "gqa", "segmented"])
def test_paged_attention_decode_op_matches_pallas(variant):
    hq, hkv, ps, np_, ctx = 6, 2, 16, 5, [75, 0, 16, 1]
    d = 64
    q, kp, vp, pt = make_case(5, len(ctx), hq, hkv, d, ps, np_)
    ctx = np.asarray(ctx, np.int32)
    want = jops.paged_attention_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(ctx), variant=variant, tile=8, num_segments=4)
    got = tops.paged_attention_decode(
        t(q), t(kp), t(vp), t(pt), t(ctx), variant=variant, tile=8,
        num_segments=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got.numpy()[1] == 0).all()


@pytest.mark.parametrize("case", PREFILL_CASES[:2])
def test_paged_attention_prefill_op_matches_pallas(case):
    hq, hkv, ps, tile, np_, ctx, qlens, block_q = case
    qt, kp, vp, pt, ctx, qsl, qlens = _ragged(6, ctx, qlens, hq, hkv, ps, np_)
    args = (qt, kp, vp, pt, ctx, qsl, qlens)
    want = jops.paged_attention_prefill(
        *(jnp.asarray(a) for a in args), block_q=block_q, tile=tile)
    got = tops.paged_attention_prefill(*(t(a) for a in args),
                                       block_q=block_q, tile=tile)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got.numpy()[qsl[-1]:] == 0).all()  # padded tail rows


@pytest.mark.parametrize("variant", ["gqa", "segmented"])
def test_paged_attention_unified_op_matches_pallas(variant):
    """Engine layout: ms = 3 decode rows (one dead), then chunks."""
    ms, hq, hkv, ps, np_ = 3, 6, 2, 16, 6
    d = 64
    dec_ctx = [33, 0, 80]
    ch_ctx, ch_q = [40, 21, 0], [40, 5, 0]  # fresh, resumed, empty slot
    s = ms + len(ch_ctx)
    q, kp, vp, pt = make_case(7, s, hq, hkv, d, ps, np_)
    ctx = np.asarray(dec_ctx + ch_ctx, np.int32)
    qlens = np.asarray([1] * ms + ch_q, np.int32)
    qsl = np.concatenate([[0], np.cumsum(qlens)]).astype(np.int32)
    tt = ms + 64  # pow2-bucketed chunk region
    qt = np.random.default_rng(8).standard_normal((tt, hq, d)).astype(
        np.float32)
    args = (qt, kp, vp, pt, ctx, qsl, qlens)
    kw = dict(num_decode_seqs=ms, variant=variant, num_segments=4)
    want = jops.paged_attention_unified(*(jnp.asarray(a) for a in args), **kw)
    got = tops.paged_attention_unified(*(t(a) for a in args), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got.numpy()[1] == 0).all()


def test_unified_decode_region_overflow_raises():
    q = torch.zeros((2, 2, 64))
    pages = torch.zeros((1, 3, 16, 64))
    meta = torch.zeros((2, 2), dtype=torch.int32)
    lens = torch.ones((2,), dtype=torch.int32)
    with pytest.raises(ShardingError, match="decode region"):
        tops.paged_attention_unified(
            q, pages, pages, meta, lens, torch.arange(3, dtype=torch.int32),
            lens, num_decode_seqs=3)


def test_wrappers_reject_bad_inputs():
    """Checks run before either path: dtype, metadata type, shapes."""
    q = torch.zeros((2, 1, 2, 64))
    kv = torch.zeros((1, 3, 2, 8, 64))
    pt = torch.zeros((2, 2), dtype=torch.int32)
    ctx = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(TypeError):
        TK.paged_decode(q.double(), kv.double(), kv.double(), pt, ctx,
                        cells_per_kv=1, scale=1.0)
    with pytest.raises(TypeError):
        TK.paged_decode(q, kv, kv, pt.long(), ctx, cells_per_kv=1, scale=1.0)
    with pytest.raises(ValueError):
        TK.paged_decode(q, kv[..., :32], kv[..., :32], pt, ctx,
                        cells_per_kv=1, scale=1.0)
    seg = dict(num_segments=1, tiles_per_segment=2, scale=1.0)
    with pytest.raises(TypeError):
        TK.paged_decode_segmented_merged(q.double(), kv.double(),
                                         kv.double(), pt, ctx, **seg)
    with pytest.raises(TypeError):
        TK.paged_decode_segmented_merged(q, kv, kv, pt, ctx.long(), **seg)
    with pytest.raises(ValueError, match="head_dim"):
        TK.paged_decode_segmented_merged(q, kv[..., :32], kv[..., :32], pt,
                                         ctx, **seg)


def test_wrappers_reject_inconsistent_shapes():
    """A cell count that does not match Hkv * cells_per_kv, or metadata of
    the wrong length, would read out of bounds on the card: rejected."""
    kv = torch.zeros((2, 3, 2, 8, 64))
    pt = torch.zeros((2, 2), dtype=torch.int32)
    ctx = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="cells_per_kv"):
        TK.paged_decode(torch.zeros((2, 6, 1, 64)), kv, kv, pt, ctx,
                        cells_per_kv=2, scale=1.0)
    with pytest.raises(ValueError, match="context_lens"):
        TK.paged_decode(torch.zeros((2, 2, 3, 64)), kv, kv, pt, ctx[:1],
                        cells_per_kv=1, scale=1.0)
    with pytest.raises(ValueError, match="num_segments"):
        TK.paged_decode_segmented(torch.zeros((2, 2, 3, 64)), kv, kv, pt,
                                  ctx, num_segments=0, tiles_per_segment=1,
                                  scale=1.0)
    merged = TK.paged_decode_segmented_merged
    with pytest.raises(ValueError, match="tiles_per_segment"):
        merged(torch.zeros((2, 2, 3, 64)), kv, kv, pt, ctx, num_segments=2,
               tiles_per_segment=0, scale=1.0)
    with pytest.raises(ValueError, match="Hkv"):
        merged(torch.zeros((2, 4, 3, 64)), kv, kv, pt, ctx, num_segments=2,
               tiles_per_segment=2, scale=1.0)
    with pytest.raises(ValueError, match="context_lens"):
        merged(torch.zeros((2, 2, 3, 64)), kv, kv, pt, ctx[:1],
               num_segments=2, tiles_per_segment=2, scale=1.0)
    qb = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(ValueError, match="qb_seq"):
        TK.paged_prefill_qblock(torch.zeros((4, 2, 6, 64)), kv, kv, qb[:3],
                                qb, pt, ctx, block_q=2, group=3, scale=1.0)
    with pytest.raises(ValueError, match="Hkv"):
        TK.paged_prefill_qblock(torch.zeros((4, 1, 6, 64)), kv, kv, qb, qb,
                                pt, ctx, block_q=2, group=3, scale=1.0)
