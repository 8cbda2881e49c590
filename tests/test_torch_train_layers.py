"""The training path's layers against the JAX reference on the CPU, fp32,
inputs from numpy seeds:

  * the flash backward of every forward: `flash_attention`'s gradients
    (kernel forward + recompute backward, the plain versions here) against
    `jax.grad` of `flash_attention_xla` at key / value widths 192 / 128
    and 48 / 32, with and without a per-batch `kv_len` (a 0 among them),
    causal, group 1 and 2 (atol 1e-5: fp32 sums in another order);
  * `MoE.forward(mode="train")` against `moe_ffn` (the GShard capacity
    dispatch): y, aux, and the gradients of sum(y r) + aux for x, the
    router and every expert leaf, at top-1, -2 and -6, a capacity factor
    of 0.25 (tokens dropped), T 6144 (3 groups of 2048, top-2: at top-1
    the routing weight is p / p, whose router gradient is rounding noise
    on both sides), a shared expert, exact router ties; the kept slots
    against a sequential numpy walk of the reference's priority rule;
  * `MLAAttention.forward_train` against `_mla_attention(mode="train")`
    with and without q_lora: the output and every weight's gradient.

The MoE's x gradient passes the reference's bf16 dispatch einsum, so it
is rounded to bf16 on both sides: an fp32 difference of one rounding in
the expert products can move a rounded value by one bf16 ulp.  So at
most 0.1% of its elements may differ by more than 1e-5, and none by more
than one bf16 ulp (2^-8) of the largest gradient.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.kernels.flash_attention.ref import flash_attention_xla
from repro.models import attention as JATT
from repro.models import moe as JMOE
from repro_torch import weights
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.models.attention import MLAAttention
from repro_torch.models.moe import MoE, capacity_layout

DSV2 = "deepseek-v2-236b"
GRAD_TOL = dict(atol=1e-5, rtol=1e-5)  # fp32, summation order


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced models are tiny: one intra-op thread per test process
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close_grad(got, want, what):
    """A weight's gradient: fp32 sums over every token in another order,
    whose rounding scales with the largest element (2e-6 of it)."""
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=1e-5, err_msg=str(what),
        atol=2e-6 * max(1.0, float(np.abs(want).max())))


def _cfgs(arch=DSV2, **moe):
    jcfg = jreduced(JARCHS[arch]).replace(dtype="float32")
    tcfg = treduced(TARCHS[arch]).replace(dtype="float32")
    if moe:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe))
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, **moe))
    return jcfg, tcfg


def _load(module, leaves, p_np):
    with torch.no_grad():
        for path, t in leaves(module):
            src = p_np
            for key in path:
                src = src[key]
            t.copy_(torch.from_numpy(np.array(src)))
    return module.requires_grad_(True)


def _tree_get(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


# ---------------------------------------------------------------------------
# the flash backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("widths", [(192, 128), (48, 32)])
@pytest.mark.parametrize("kv_len", [None, (24, 13, 0)])
@pytest.mark.parametrize("group", [1, 2])
def test_flash_gradients_match_reference(widths, kv_len, group):
    dk, dv = widths
    b, s, hkv = 3, 24, 2
    rng = np.random.default_rng(dk + group)
    q = rng.standard_normal((b, s, hkv * group, dk)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, dk)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dv)).astype(np.float32)
    r = rng.standard_normal((b, s, hkv * group, dv)).astype(np.float32)
    scale = dk ** -0.5
    jl = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)

    def f(q, k, v):
        o = flash_attention_xla(q, k, v, causal=True, scale=scale,
                                kv_block=8, kv_len=jl)
        return jnp.sum(o * r)

    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)
    xs = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    tl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    o = fops.flash_attention(*xs, causal=True, scale=scale, kv_len=tl)
    assert o.shape == (b, s, hkv * group, dv)
    torch.sum(o * torch.from_numpy(r)).backward()
    for name, x, w in zip("qkv", xs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w),
                                   err_msg=name, **GRAD_TOL)
    if kv_len is not None:  # nothing flows to or from the dead keys
        assert not xs[1].grad[2].any() and not xs[2].grad[1, 13:].any()


# ---------------------------------------------------------------------------
# the MoE capacity dispatch
# ---------------------------------------------------------------------------

MOE_CASES = {  # top_k, num_experts, capacity_factor, tokens, shared, ties
    "top1": (1, 4, 2.0, 32, 1, False),
    "top2_shared": (2, 4, 2.0, 32, 2, False),
    "top6": (6, 8, 1.25, 48, 2, False),
    "top2_drops": (2, 4, 0.25, 32, 1, False),
    "top6_drops": (6, 8, 0.25, 48, 0, False),
    "three_groups": (2, 4, 1.0, 6144, 1, False),
    "ties": (2, 4, 1.0, 32, 1, True),
}


def _moe_case(case):
    top_k, e, cf, t, shared, ties = MOE_CASES[case]
    jcfg, tcfg = _cfgs(top_k=top_k, num_experts=e, capacity_factor=cf,
                       num_shared_experts=shared)
    p = JMOE.init_moe(jcfg, jax.random.key(1))
    p_np = jax.tree.map(np.asarray, p)
    if ties:  # zero router weights: every probability 1/E, ties throughout
        p_np["router"]["w"] = np.zeros_like(p_np["router"]["w"])
        p = jax.tree.map(jnp.asarray, p_np)
    moe = _load(MoE(tcfg), weights._moe_leaves, p_np)
    rng = np.random.default_rng(t + e)
    x = rng.standard_normal((2, t // 2, tcfg.d_model)).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)
    return jcfg, p, moe, x, r


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_train_matches_reference(case):
    jcfg, p, moe, x, r = _moe_case(case)

    def f(p, x):
        y, aux = JMOE.moe_ffn(jcfg, p, x)
        return jnp.sum(y * r) + aux, (y, aux)

    (_, (want, want_aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe(xt, mode="train")
    (torch.sum(y * torch.from_numpy(r)) + aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               **GRAD_TOL)
    np.testing.assert_allclose(float(aux.detach()), float(want_aux),
                               rtol=1e-6)
    for path, t in weights._moe_leaves(moe):
        want_g = _tree_get(gp, path)
        if path == ("router", "w") and MOE_CASES[case][0] == 1:
            # top-1: the routing weight p / p is 1, so its gradient
            # cancels and both sides keep rounding noise of ~ulp(dL/dw /
            # p) beside the aux term's gradient (~1e-4 here)
            np.testing.assert_allclose(t.grad.numpy(), want_g, atol=1e-5)
            continue
        _close_grad(t.grad.numpy(), want_g, path)
    ref_x = np.asarray(gx)
    diff = np.abs(xt.grad.numpy() - ref_x)
    assert (diff > 1e-5).mean() <= 1e-3, (diff > 1e-5).mean()
    assert diff.max() <= 2 ** -8 * np.abs(ref_x).max(), diff.max()


@pytest.mark.parametrize("case", ["top2_drops", "top6_drops",
                                  "three_groups", "top6"])
def test_moe_capacity_slots(case):
    """The layout `moe_ffn` computes, and the slots against a sequential
    numpy walk of the reference's rule: choice j takes positions after
    every kept choice < j of the group, in token order, and a position
    >= C is dropped.  Drops where the capacity factor forces them."""
    _, _, moe, x, _ = _moe_case(case)
    top_k, e, cf, t, _, _ = MOE_CASES[case]
    sg, g, cap = capacity_layout(t, e, top_k, cf)
    assert (sg, g) == ((2048, 3) if t == 6144 else (t, 1))
    assert cap == max(int(sg * top_k * cf / e), 1)
    with torch.no_grad():
        _, topi = moe.route(torch.from_numpy(x.reshape(t, -1)))
        slot, kept = moe.capacity_slots(topi.reshape(g, sg, top_k), cap)
    ids = topi.reshape(g, sg, top_k).numpy()
    want_slot = np.zeros(ids.shape, np.int64)
    want_kept = np.zeros(ids.shape, bool)
    for gi in range(g):
        counts = np.zeros(e, np.int64)
        for j in range(top_k):
            seen = np.zeros(e, np.int64)
            for si in range(sg):
                ex = ids[gi, si, j]
                pos = counts[ex] + seen[ex]
                seen[ex] += 1
                want_kept[gi, si, j] = pos < cap
                want_slot[gi, si, j] = (ex * g + gi) * cap + pos
            for ex in range(e):
                counts[ex] += min(seen[ex], max(cap - counts[ex], 0))
    np.testing.assert_array_equal(kept.numpy(), want_kept)
    np.testing.assert_array_equal(slot.numpy()[want_kept],
                                  want_slot[want_kept])
    live = slot[kept]
    assert live.unique().numel() == live.numel()  # one row a slot
    if cf < 1:
        assert not bool(kept.all())


def test_moe_serve_mode_unchanged_by_train_mode():
    """The dropless serving path gives the same bits before and after a
    training forward and backward on the same layer."""
    _, _, moe, x, _ = _moe_case("top2_shared")
    xt = torch.from_numpy(x)
    with torch.no_grad():
        before, aux0 = moe(xt)
    y, _ = moe(xt, mode="train")
    y.sum().backward()
    with torch.no_grad():
        after, aux1 = moe(xt)
    assert torch.equal(before, after) and float(aux0) == float(aux1) == 0.0


# ---------------------------------------------------------------------------
# MLA in its expanded training form
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q_lora", [64, 0])
def test_mla_forward_train_matches_reference(q_lora):
    jcfg, tcfg = _cfgs()
    if not q_lora:
        jcfg = jcfg.replace(mla=dataclasses.replace(jcfg.mla, q_lora_rank=0))
        tcfg = tcfg.replace(mla=dataclasses.replace(tcfg.mla, q_lora_rank=0))
    p = JATT.init_attention(jcfg, jax.random.key(3))
    p_np = jax.tree.map(np.asarray, p)
    attn = _load(MLAAttention(tcfg), weights._attn_leaves, p_np)
    assert {path[0] for path, _ in weights._attn_leaves(attn)} == set(p_np)
    rng = np.random.default_rng(q_lora)
    b, s = 2, 24
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))

    def f(p, x):
        o, _ = JATT.attention(jcfg, p, x, jnp.asarray(pos), mode="train")
        return jnp.sum(o * r), o

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    o = attn.forward_train(xt, torch.from_numpy(pos))
    torch.sum(o * torch.from_numpy(r)).backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want),
                               **GRAD_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **GRAD_TOL)
    for path, t in weights._attn_leaves(attn):
        _close_grad(t.grad.numpy(), _tree_get(gp, path), path)
