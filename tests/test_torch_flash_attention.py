"""The port's flash attention (the plain version of the forward kernel and
the recompute backward) against the JAX package on identical numpy
inputs.

  * forward against `repro.kernels.flash_attention.flash_attention` (the
    Pallas kernel, interpret mode off TPU) at the kernel tests' five
    cases, with their tolerances: 2e-5 fp32, 3e-2 bf16 (the two sides
    round p to bf16 under running maxima of different KV tiles);
  * the row logsumexp against `ref._flash_fwd_core`;
  * gradients through `torch.autograd` against `jax.grad` through the
    JAX `flash_attention`, at the kernel tests' 5e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.flash_attention.ref import _flash_fwd_core
from repro_torch.kernels.flash_attention import kernel as TK
from repro_torch.kernels.flash_attention import ops as tops

CASES = [
    # (B, Sq, Skv, Hq, Hkv, D, causal, q_offset, dtype, tol)
    (2, 128, 128, 4, 2, 64, True, 0, "float32", 2e-5),
    (1, 64, 64, 8, 8, 128, True, 0, "float32", 2e-5),  # MHA
    (2, 32, 128, 4, 1, 64, True, 96, "float32", 2e-5),  # chunked (offset)
    (1, 128, 128, 16, 2, 128, False, 0, "float32", 2e-5),  # bidirectional
    (2, 128, 128, 4, 2, 64, True, 0, "bfloat16", 3e-2),
]


def _inputs(case, seed=0):
    b, sq, skv, hq, hkv, d = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_pallas(case):
    *_, causal, off, dt, tol = case
    q, k, v = _inputs(case)
    jd, td = getattr(jnp, dt), getattr(torch, dt)
    want = jflash(*(jnp.asarray(x, jd) for x in (q, k, v)), causal=causal,
                  q_offset=off, block_q=32, kv_block=32)
    got = tops.flash_attention(*(torch.from_numpy(x).to(td)
                                 for x in (q, k, v)),
                               causal=causal, q_offset=off)
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# the shapes the bf16 tensor-core kernel is held to on the card, against
# the Pallas op (its block_q / kv_block must divide Sq / Skv):
# (B, Sq, Skv, Hq, Hkv, D, causal, q_offset, dtype, tol, jax block)
MMA_CASES = [
    (1, 24, 24, 9, 3, 64, True, 0, "bfloat16", 3e-2, 8),  # 24-row blocks
    (1, 40, 136, 16, 2, 128, True, 96, "bfloat16", 3e-2, 8),  # D 128
    (1, 40, 136, 16, 2, 128, True, 96, "float32", 2e-5, 8),
]


@pytest.mark.parametrize("case", MMA_CASES)
def test_forward_matches_pallas_at_tensor_core_shapes(case):
    *_, causal, off, dt, tol, blk = case
    q, k, v = _inputs(case, seed=5)
    jd, td = getattr(jnp, dt), getattr(torch, dt)
    want = jflash(*(jnp.asarray(x, jd) for x in (q, k, v)), causal=causal,
                  q_offset=off, block_q=blk, kv_block=blk)
    got = tops.flash_attention(*(torch.from_numpy(x).to(td)
                                 for x in (q, k, v)),
                               causal=causal, q_offset=off)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("case", CASES[:4])
def test_lse_matches_reference(case):
    b, sq, _, hq, hkv, d, causal, off, _, tol = case
    q, k, v = _inputs(case, seed=1)
    _, want = _flash_fwd_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal, d ** -0.5, 32, off, None)
    qp = tops.pack_q(torch.from_numpy(q), hkv)
    kp, vp = (torch.from_numpy(x).permute(0, 2, 1, 3).contiguous()
              for x in (k, v))
    _, got = tops.flash_forward(qp, kp, vp, group=hq // hkv, causal=causal,
                                scale=d ** -0.5, q_offset=off)
    # reference lse [B, Sq, Hkv, G] -> the packed rows [B, Hkv, Sq*G]
    want = np.asarray(want).transpose(0, 2, 1, 3).reshape(b, hkv, -1)
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)


def test_dead_rows_are_exact_zeros():
    """Non-causal attention over zero keys: every row saw no live key, so
    o is exactly 0 and lse is the mask value (the l == 0 -> 1 guard)."""
    q = torch.randn(2, 1, 8, 16, generator=torch.Generator().manual_seed(0))
    k = torch.zeros(2, 0, 16)
    o, lse = TK.flash_attention_fwd(q, k, k, block_q=1, group=8, scale=0.25,
                                    causal=False, q_offset=0)
    assert (o == 0).all()
    assert (lse == TK.NEG_INF).all()


@pytest.mark.parametrize("case", [
    (2, 64, 64, 4, 2, 64, True, 0),
    (1, 32, 96, 6, 2, 32, True, 64),
    (1, 48, 48, 4, 4, 64, False, 0),
])
def test_gradients_match_jax(case):
    *_, causal, off = case
    q, k, v = _inputs(case, seed=2)
    w = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)

    def jloss(q, k, v):
        o = jflash(q, k, v, causal=causal, q_offset=off, block_q=16,
                   kv_block=16)
        return jnp.sum(o * jnp.asarray(w))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = tops.flash_attention(tq, tk, tv, causal=causal, q_offset=off)
    torch.sum(out * torch.from_numpy(w)).backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5,
                                   rtol=5e-5)


def test_backward_block_size_does_not_change_grads():
    """The backward's KV block (and the causal row slicing it enables)
    only regroups the sums."""
    rng = np.random.default_rng(4)
    qp = torch.from_numpy(rng.standard_normal((1, 2, 96, 32)).astype(
        np.float32))
    kp, vp = (torch.from_numpy(rng.standard_normal((1, 2, 48, 32)).astype(
        np.float32)) for _ in range(2))
    dop = torch.from_numpy(rng.standard_normal((1, 2, 96, 32)).astype(
        np.float32))
    kw = dict(group=2, causal=True, scale=32 ** -0.5, q_offset=0)
    op, lse = tops.flash_forward(qp, kp, vp, **kw)
    whole = tops.flash_backward(qp, kp, vp, op, lse, dop, kv_block=48, **kw)
    split = tops.flash_backward(qp, kp, vp, op, lse, dop, kv_block=16, **kw)
    for a, b in zip(whole, split):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_pick_block_q():
    assert tops.pick_block_q(2048, 3) == 16  # 48 rows
    assert tops.pick_block_q(2048, 1) == 64
    assert tops.pick_block_q(96, 8) == 8
    assert tops.pick_block_q(33, 2) == 1
    with pytest.raises(ValueError, match="group"):
        tops.pick_block_q(64, 65)


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros(2, 4, 6, 16)
    k = torch.zeros(2, 32, 16)
    with pytest.raises(ValueError, match="block_q"):
        TK.flash_attention_fwd(q, k, k, block_q=4, group=2, scale=1.0,
                               causal=True, q_offset=0)
    with pytest.raises(TypeError, match="dtypes"):
        TK.flash_attention_fwd(q, k.bfloat16(), k, block_q=2, group=3,
                               scale=1.0, causal=True, q_offset=0)
    with pytest.raises(ValueError, match="q_offset"):
        TK.flash_attention_fwd(q, k, k, block_q=2, group=3, scale=1.0,
                               causal=True, q_offset=-1)
