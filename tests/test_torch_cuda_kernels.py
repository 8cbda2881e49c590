"""The CUDA paged-attention kernels against their plain PyTorch versions on
the card, and the port's engine on the card against itself on the CPU.

Needs an NVIDIA GPU and nvcc: every test here is marked `cuda` and skips
on a host without CUDA.  Run on the card with

    python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Imports neither JAX nor the JAX package.  Tolerances: fp32 atol 1e-4
with TF32 off (summation order), bf16 atol 2e-2 (an output ulp near 1 is
7.8e-3; p is rounded to bf16 before p.V on both sides).
"""
import numpy as np
import pytest
import torch

from repro_torch import weights
from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels.paged_attention import kernel as K
from repro_torch.kernels.paged_attention import ops
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


CASES = [  # hkv, group, page, tile, contexts
    (3, 3, 16, 16, [0, 1, 17, 300, 77]),
    (2, 1, 16, 8, [40, 0, 5]),
    (1, 4, 24, 24, [95, 24, 0, 1]),
    (2, 2, 24, 8, [13, 200]),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_decode_kernels_match_plain(cuda, dtype, case):
    hkv, group, ps, tile, ctx = case
    q, kp, vp, pt, cl = _case(cuda, dtype, hkv, group, ps, ctx)
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
    for nseg in (1, 3, num_tiles + 2):
        nseg = min(nseg, num_tiles)
        kw = dict(num_segments=nseg, tiles_per_segment=-(-num_tiles // nseg),
                  scale=0.125)
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
        got = K.segment_reduce(*parts, dtype)
        torch.testing.assert_close(
            got.float(), K.segment_reduce_plain(*parts, dtype).float(),
            atol=ATOL[dtype], rtol=0)
    assert K.LAUNCHES["paged_decode"] == n0["paged_decode"] + 2
    assert K.LAUNCHES["segment_reduce"] == n0["segment_reduce"] + 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_unified_op_matches_plain(cuda, dtype, case):
    """Decode region + a fresh and a resumed chunk through ops on the card
    vs the same call on the CPU (plain versions)."""
    hkv, group, ps, tile, ctx = case
    ms = len(ctx)
    q, kp, vp, pt, cl = _case(cuda, dtype, hkv, group, ps, ctx + [40, 90],
                              seed=1)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_wide_block_uses_dynamic_shared_memory(cuda, dtype):
    """block_q 32 x group 4 rows at head_dim 128 need ~149 KB of shared
    memory per block: above the 48 KB default, so the launch opts in."""
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
