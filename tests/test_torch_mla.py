"""The port's MLA (deepseek-v2) against the JAX reference on the CPU, on
`reduced(ARCHS["deepseek-v2-236b"])` in fp32 (4 layers, d 256, 32 heads,
q_lora 64, kv_lora 64, nope 32, rope 32, v 64, 4 experts top-2 of ff 128,
2 shared), weights carried across by `weights.from_jax_params`, inputs
from numpy seeds:

  * `MLAAttention` prefill then decode against `_mla_attention` (through
    `attention(mode=...)`), with `q_lora_rank` 64 and 0, with
    `mla_fused_prefill` and `decode_blockscan` on and off: outputs and the
    cached [latent | k_rope] rows at 1e-5;
  * the latent decode's plain version against the reference's
    `decode_attention("xla", q, k_pages, None, ..., v_dim=r)` and
    `decode_attention_blockscan` (dead rows, contexts ending mid-page, a
    single page) at 1e-5 (kernels); the split-KV segment choice;
  * the widened flash forward's plain version (key width 192, value width
    128, ragged `kv_len` with a 0) against `flash_attention_xla(...,
    kv_len=)` and `mha_reference` at 1e-5; the training path (equal
    widths, no kv_len) bit for bit what it was; the backward refused;
  * `apply_prefill` / `apply_decode` logits against `M.apply_prefill` /
    `M.apply_decode` at 1e-4, with `first_k_dense` 0 and 1;
  * the port's `Engine` against the JAX `Engine` token for token on the
    padded step (also a preempting trace): outputs, steps,
    `compile_events` keys, dispatch and device calls, no leaked page;
  * packed, chunked and prefix-cached MLA refused as the reference
    refuses them; the weight bridge both ways; `init_random`;
    `launch.serve --arch deepseek-v2-236b --reduced --device cpu`.

Every JAX call is on the CPU; the JAX engines run only where compared.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.core.attention import backend as JB
from repro.kernels.flash_attention.ref import (flash_attention_xla,
                                               mha_reference)
from repro.models import attention as JATT
from repro.models import model as JM
from repro.serving.engine import Engine as JEngine
from repro.serving.request import Request as JRequest
from repro_torch import weights
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.core.attention import backend as TB
from repro_torch.core.paged.kv_cache import physical_slots, write_index
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.mla_decode import kernel as AK
from repro_torch.kernels.mla_decode import ops as aops
from repro_torch.kernels._common import (NEG_INF, _finalize, _init_state,
                                         _tile_update)
from repro_torch.models import model as TM
from repro_torch.models.attention import MLAAttention, kv_cache_dims
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.request import Request as TRequest, State
from repro_torch.utils.misc import cdiv

ARCH = "deepseek-v2-236b"
ROOT = pathlib.Path(__file__).resolve().parents[1]
KERNEL_TOL = dict(atol=1e-5, rtol=1e-5)  # fp32, summation order
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)   # 4 layers of it


def _cfgs(**kw):
    kw = {"dtype": "float32", **kw}
    return (jreduced(JARCHS[ARCH]).replace(**kw),
            treduced(TARCHS[ARCH]).replace(**kw))


@pytest.fixture(scope="module")
def dsv2():
    jcfg, tcfg = _cfgs()
    params = JM.init(jcfg, jax.random.key(0))
    params_np = jax.tree.map(np.asarray, params)
    model = weights.from_jax_params(tcfg, params_np, device="cpu")
    return jcfg, tcfg, params, params_np, model


@pytest.fixture(scope="module")
def dsv2_lead(dsv2):
    """`first_k_dense=1` (deepseek-v2's own layout): the reference's tree
    with one leading dense block in "lead_blocks" (layer 0's attention, a
    SwiGLU MLP drawn with numpy), the MoE blocks after it."""
    jcfg, tcfg, _, params_np, _ = dsv2
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, first_k_dense=1))
    tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, first_k_dense=1))
    rng = np.random.default_rng(2)
    d, f = tcfg.d_model, tcfg.d_ff
    blocks = params_np["blocks"]
    lead = jax.tree.map(lambda a: a[0],
                        {k: v for k, v in blocks.items() if k != "moe"})
    lead["mlp"] = {k: {"w": (rng.standard_normal(s) * s[0] ** -0.5
                             ).astype(np.float32)}
                   for k, s in (("gate", (d, f)), ("up", (d, f)),
                                ("down", (f, d)))}
    params_np = dict(params_np, lead_blocks=[lead],
                     blocks=jax.tree.map(lambda a: a[1:], blocks))
    params = jax.tree.map(jnp.asarray, params_np)
    model = weights.from_jax_params(tcfg, params_np, device="cpu")
    return jcfg, tcfg, params, params_np, model


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# the attention layer
# ---------------------------------------------------------------------------


def _layer(q_lora, fused, blockscan):
    """(jcfg, reference attention params, the port's MLAAttention holding
    them)."""
    jcfg, tcfg = _cfgs(mla_fused_prefill=fused, decode_blockscan=blockscan)
    if not q_lora:
        jcfg = jcfg.replace(mla=dataclasses.replace(jcfg.mla, q_lora_rank=0))
        tcfg = tcfg.replace(mla=dataclasses.replace(tcfg.mla, q_lora_rank=0))
    p = JATT.init_attention(jcfg, jax.random.key(3))
    attn = MLAAttention(tcfg)
    p_np = jax.tree.map(np.asarray, p)
    with torch.no_grad():
        for path, t in weights._attn_leaves(attn):
            src = p_np
            for key in path:
                src = src[key]
            t.copy_(torch.from_numpy(np.array(src)))
    assert {path[0] for path, _ in weights._attn_leaves(attn)} == set(p_np)
    return jcfg, p, attn


@pytest.mark.parametrize("q_lora", [64, 0])
@pytest.mark.parametrize("flags", ["plain", "fused_prefill+blockscan"])
def test_mla_attention_matches_reference(q_lora, flags):
    """Prefill of 3 rows (24, 13 and 0 valid tokens of 24), then one
    decode token each (the third slot dead)."""
    on = flags != "plain"
    jcfg, p, attn = _layer(q_lora, on, on)
    rng = np.random.default_rng(5)
    b, s, np_, ps = 3, 24, 2, jcfg.page_size
    num_pages = b * np_ + 1
    _, dk, _ = kv_cache_dims(jcfg)
    pt = np.arange(1, 1 + b * np_, dtype=np.int32).reshape(b, np_)
    qlens = np.asarray([24, 13, 0], np.int32)
    kp = np.zeros((1, 1, num_pages, ps, dk), np.float32)

    def run(x, pos, meta_np, mode, kp):
        jmeta, tmeta = _both(meta_np)
        valid = (np.arange(pos.shape[1])[None] < qlens[:, None]
                 if mode == "prefill"
                 else (pos >= 0) & (meta_np["context_lens"][:, None] > 0))
        slots = physical_slots(tmeta["page_table"], torch.from_numpy(pos),
                               torch.from_numpy(valid), ps, num_pages)
        tmeta["write_index"] = write_index(slots.reshape(1, -1),
                                           num_pages * ps)
        want, jc = JATT.attention(jcfg, p, jnp.asarray(x), jnp.asarray(pos),
                                  mode=mode, cache={"k_pages": kp},
                                  meta=jmeta)
        tk = torch.from_numpy(np.array(kp))
        fwd = attn.forward_prefill if mode == "prefill" \
            else attn.forward_decode
        with torch.no_grad():
            got = fwd(torch.from_numpy(x), torch.from_numpy(pos), tk, None,
                      tmeta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **KERNEL_TOL)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jc["k_pages"]),
                                   **KERNEL_TOL)
        return jc["k_pages"]

    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    kp = run(x, pos, {"page_table": pt, "context_lens": qlens,
                      "query_lens": qlens}, "prefill", jnp.asarray(kp))
    x = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
    pos = np.asarray([[24], [13], [-1]], np.int32)
    run(x, pos, {"page_table": pt,
                 "context_lens": np.asarray([25, 14, 0], np.int32)},
        "decode", kp)


def test_mla_attention_refuses_unified_and_training():
    _, _, attn = _layer(64, False, False)
    with pytest.raises(ValueError, match="unified packed step"):
        attn(torch.zeros((1, 2, 256)), None, None, None, {})
    with pytest.raises(NotImplementedError, match="MLA training"):
        attn.forward_train(torch.zeros((1, 2, 256)), None)


# ---------------------------------------------------------------------------
# the latent decode (plain version) and the widened flash forward
# ---------------------------------------------------------------------------

DECODE_CASES = {  # (heads, r, rope, page, contexts)
    "dead_rows_mid_page": (8, 64, 32, 16, [0, 1, 17, 70, 0, 33]),
    "one_page": (4, 64, 32, 16, [16, 3, 0]),
    "long_page_24": (16, 32, 16, 24, [200, 5, 121]),
}


def _decode_inputs(case, seed=0):
    h, r, rope, ps, ctx = DECODE_CASES[case]
    rng = np.random.default_rng(seed)
    s = len(ctx)
    np_ = max(1, cdiv(max(ctx), ps))
    p = s * np_ + 1
    q = rng.standard_normal((s, h, r + rope)).astype(np.float32)
    kp = rng.standard_normal((p, ps, r + rope)).astype(np.float32)
    pt = (rng.permutation(p - 1)[:s * np_].reshape(s, np_) + 1).astype(
        np.int32)
    return q, kp, pt, np.asarray(ctx, np.int32), r


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_plain_mla_decode_matches_reference(case):
    q, kp, pt, ctx, r = _decode_inputs(case)
    scale = q.shape[-1] ** -0.5
    args = (jnp.asarray(q), jnp.asarray(kp)[None, None], None,
            jnp.asarray(pt), jnp.asarray(ctx))
    want = JB.decode_attention("xla", *args, scale=scale, v_dim=r)
    want_bs = JB.decode_attention_blockscan(*args, scale=scale, v_dim=r)
    tq, tkp, tpt, tctx = (torch.from_numpy(a) for a in (q, kp, pt, ctx))
    got = AK.mla_decode(tq, tkp, tpt, tctx, v_dim=r, scale=scale)
    via_backend = TB.mla_decode_attention(tq, tkp[None, None], tpt, tctx,
                                          v_dim=r, scale=scale)
    for w in (want, want_bs):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **KERNEL_TOL)
    assert torch.equal(got, via_backend)
    dead = ctx == 0
    assert not got[torch.from_numpy(dead)].any()  # dead rows: exact zeros
    assert AK.LAUNCHES[AK.NAME] == 0  # the CPU never launches the kernel


def test_mla_decode_split_and_arguments():
    # deepseek-v2's decode step on 132 SMs: 8 rows x 128 heads over a
    # 2048-key table splits 5 ways; 64 rows fill the card unsplit
    assert aops.split(8, 128, 2048, 132) == (5, 448)
    assert aops.split(64, 128, 4096, 132) == (1, 4096)
    assert aops.split(1, 32, 16, 132) == (1, 64)
    for s, h, keys, sms in ((3, 8, 1000, 132), (8, 128, 17 * 16, 132)):
        nseg, seg = aops.split(s, h, keys, sms)
        assert seg % AK.SEG_ALIGN == 0 and nseg * seg >= keys
        assert (nseg - 1) * seg < keys  # no segment past the table
    q, kp, pt, ctx, r = _decode_inputs("dead_rows_mid_page")
    tq, tkp, tpt, tctx = (torch.from_numpy(a) for a in (q, kp, pt, ctx))
    with pytest.raises(ValueError, match="segments"):
        AK.mla_decode(tq, tkp, tpt, tctx, v_dim=r, scale=1.0,
                      num_segments=1, seg_keys=64)
    with pytest.raises(TypeError, match="int32"):
        AK.mla_decode(tq, tkp, tpt.long(), tctx, v_dim=r, scale=1.0)
    with pytest.raises(ValueError, match="v_dim"):
        AK.mla_decode(tq, tkp, tpt, tctx, v_dim=q.shape[-1] + 8, scale=1.0)


FLASH_CASES = {  # (B, S, H, Dk, Dv, kv_len)
    "mla_widths_ragged": (3, 40, 2, 192, 128, [40, 17, 0]),
    "mla_widths_tiles": (2, 130, 1, 192, 128, [130, 65]),
    "reduced_widths": (2, 24, 4, 64, 64, [24, 13]),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_plain_flash_kv_len_matches_reference(case):
    b, s, h, dk, dv, kvl = FLASH_CASES[case]
    rng = np.random.default_rng(9)
    q, k = (rng.standard_normal((b, s, h, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    kv_len = np.asarray(kvl, np.int32)
    scale = dk ** -0.5
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    kv_block = 8 if s % 8 == 0 else 2
    want = flash_attention_xla(*jargs, causal=True, scale=scale,
                               kv_block=kv_block, kv_len=jnp.asarray(kv_len))
    oracle = mha_reference(*jargs, causal=True, scale=scale,
                           kv_len=jnp.asarray(kv_len))
    got = fops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=True, scale=scale,
                               kv_len=torch.from_numpy(kv_len))
    for w in (want, oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **KERNEL_TOL)


def _flash_plain_as_it_was(q, k, v, *, block_q, group, scale, causal,
                           q_offset):
    """`flash_attention_fwd_plain` before value widths and kv_len, line for
    line."""
    bh, nq, bm, d = q.shape
    skv = k.shape[1]
    q_pos = (q_offset + torch.arange(nq)[:, None] * block_q
             + torch.arange(bm)[None, :] // group)
    n_t = cdiv(skv, FK.KV_TILE)
    if causal:
        n_t = min(n_t, cdiv(q_offset + nq * block_q, FK.KV_TILE))
    qf = q.float()
    acc, m, l = _init_state(q.shape, q.device)
    for t in range(n_t):
        kt = k[:, None, t * FK.KV_TILE:(t + 1) * FK.KV_TILE]
        vt = v[:, None, t * FK.KV_TILE:(t + 1) * FK.KV_TILE]
        kv_pos = t * FK.KV_TILE + torch.arange(kt.shape[2])
        mask = (kv_pos[None, None, :] <= q_pos[:, :, None]) if causal else \
            torch.ones((nq, bm, kv_pos.numel()), dtype=torch.bool)
        acc, m, l = _tile_update(qf, kt, vt, mask.expand(bh, -1, -1, -1),
                                 scale, acc, m, l)
    lse = torch.where(l == 0.0, NEG_INF,
                      m + torch.log(torch.where(l == 0.0, 1.0, l)))
    return _finalize(acc, l, q.dtype), lse


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (True, 40),
                                             (False, 0)])
def test_flash_training_path_unchanged(causal, q_offset):
    """Equal widths, no kv_len: the plain forward gives the bits it gave
    before it was widened, and the gradient still flows."""
    g = torch.Generator().manual_seed(4)
    q = torch.randn((6, 5, 6, 32), generator=g)  # BH 6, 5 blocks of 2 x 3
    k, v = (torch.randn((6, 150, 32), generator=g) for _ in range(2))
    kw = dict(block_q=2, group=3, scale=0.2, causal=causal,
              q_offset=q_offset)
    o, lse = FK.flash_attention_fwd(q, k, v, **kw)
    o0, lse0 = _flash_plain_as_it_was(q, k, v, **kw)
    assert torch.equal(o, o0) and torch.equal(lse, lse0)
    x = torch.randn((2, 16, 4, 32), generator=g, requires_grad=True)
    y = torch.randn((2, 16, 2, 32), generator=g, requires_grad=True)
    fops.flash_attention(x, y, y).sum().backward()
    assert x.grad is not None and y.grad.abs().sum() > 0


def test_flash_backward_refuses_mla_forward():
    g = torch.Generator().manual_seed(1)
    q = torch.randn((1, 8, 2, 48), generator=g, requires_grad=True)
    k = torch.randn((1, 8, 2, 48), generator=g)
    v = torch.randn((1, 8, 2, 32), generator=g)
    with pytest.raises(NotImplementedError, match="backward"):
        fops.flash_attention(q, k, v).sum().backward()
    with pytest.raises(NotImplementedError, match="backward"):
        fops.flash_attention(q, k, k, kv_len=torch.tensor(
            [5], dtype=torch.int32)).sum().backward()


# ---------------------------------------------------------------------------
# the model's serving steps and the weight bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["plain", "first_k_dense"])
def test_prefill_then_decode_match_reference(dsv2, dsv2_lead, variant):
    jcfg, tcfg, params, _, model = dsv2 if variant == "plain" else dsv2_lead
    assert len(model.lead_blocks) == (variant == "first_k_dense")
    b, s, np_ = 2, 24, 3
    pt = np.arange(1, 1 + b * np_, dtype=np.int32).reshape(b, np_)
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, jcfg.vocab_size, size=(b, s + 1)).astype(
        np.int32)
    qlens = np.asarray([s, 13], np.int32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    jcache = JM.make_cache(jcfg, max_seqs=b, num_pages=b * np_ + 1)
    tcache = TM.make_cache(tcfg, max_seqs=b, num_pages=b * np_ + 1,
                           device="cpu")
    assert set(tcache["attn"]) == set(jcache["attn"]) == {"k_pages"}
    assert tuple(tcache["attn"]["k_pages"].shape) == \
        jcache["attn"]["k_pages"].shape
    jb, tb = _both({"inputs": tokens[:, :s], "positions": pos,
                    "page_table": pt, "context_lens": qlens,
                    "query_lens": qlens})
    jl, jcache = JM.apply_prefill(jcfg, params, jcache, jb)
    tl, tcache = TM.apply_prefill(model, tcache, tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    jb, tb = _both({"inputs": tokens[np.arange(b), qlens][:, None],
                    "positions": qlens[:, None], "page_table": pt,
                    "context_lens": qlens + 1})
    jl, jcache = JM.apply_decode(jcfg, params, jcache, jb)
    tl, tcache = TM.apply_decode(model, tcache, tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(tcache["attn"]["k_pages"].numpy(),
                               np.asarray(jcache["attn"]["k_pages"]),
                               **KERNEL_TOL)


def test_weight_bridge_round_trips(dsv2_lead):
    _, tcfg, _, params_np, model = dsv2_lead
    back = weights.to_numpy_params(model)
    assert jax.tree.structure(back) == jax.tree.structure(params_np)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(params_np)):
        np.testing.assert_array_equal(got, want)
    again = weights.from_jax_params(tcfg, back, device="cpu")
    for (_, _, a), (_, _, b) in zip(weights._leaves(model),
                                    weights._leaves(again)):
        assert torch.equal(a, b)


def test_init_random_draws_mla_leaves():
    _, tcfg = _cfgs(dtype="bfloat16")
    tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, first_k_dense=1))
    model = weights.init_random(tcfg, 3, device="cpu")
    attn = model.lead_blocks[0].attn
    assert isinstance(attn, MLAAttention) and attn.q_lora
    assert torch.equal(attn.kv_norm.scale, torch.ones_like(
        attn.kv_norm.scale))
    r = tcfg.mla.kv_lora_rank
    std = r ** -0.5
    w = attn.wk_b.w.float()
    assert tuple(w.shape) == (r, tcfg.num_q_heads * tcfg.mla.qk_nope_dim)
    assert float(w.abs().max()) <= 2 * std * 1.01
    assert not torch.equal(model.blocks[0].attn.wk_b.w, attn.wk_b.w)
    again = weights.init_random(tcfg, 3, device="cpu")
    for (_, _, a), (_, _, b) in zip(weights._leaves(model),
                                    weights._leaves(again)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, vocab, size=n))) for n in lens]


@pytest.mark.parametrize("trace", ["mixed", "preempting"])
def test_engine_matches_reference(dsv2, trace):
    """"mixed": prompts of 5 / 17 / 33 tokens, 6 new each, 4 slots.
    "preempting": four requests that need ~18 pages of 16 on 13 (12
    usable): decoding requests are preempted and prefilled again."""
    jcfg, tcfg, params, _, model = dsv2
    if trace == "mixed":
        lens, new = (5, 17, 33), 6
        kw = dict(max_seqs=4, num_pages=64, max_model_len=256)
    else:
        lens, new = (40, 33, 47, 20), 24
        kw = dict(max_seqs=4, num_pages=13, max_model_len=128)
    prompts = _prompts(tcfg.vocab_size, lens, seed=7)
    jeng = JEngine(jcfg, params, **kw)
    teng = TEngine(tcfg, model, device="cpu", **kw)
    jreqs = [JRequest(prompt=list(p), max_new_tokens=new) for p in prompts]
    treqs = [TRequest(prompt=list(p), max_new_tokens=new) for p in prompts]
    jeng.generate(jreqs)
    teng.generate(treqs)
    assert all(r.state is State.FINISHED for r in treqs)
    for i, (a, b) in enumerate(zip(jreqs, treqs)):
        assert a.output == b.output, (i, a.output, b.output)
        assert a.prompt == b.prompt
    assert not teng._packed and not jeng._packed
    assert teng.compile_events == jeng.compile_events
    assert all(k[3] is None for k in teng.compile_events)
    assert teng.step_idx == jeng.step_idx
    assert teng.launched_token_slots == jeng.launched_token_slots
    assert dict(teng.dispatch_counts) == dict(jeng.dispatch_counts) == {}
    assert dict(teng.device_calls) == dict(jeng.device_calls)
    assert teng.alloc.free_pages == teng.num_pages - 1, "pages leaked"
    if trace == "preempting":
        assert any(len(r.prompt) > n for r, n in zip(treqs, lens)), \
            "no request was preempted"


def test_packed_chunked_and_prefix_cached_mla_refused(dsv2):
    jcfg, tcfg, params, _, model = dsv2
    for kw in (dict(enable_chunked_prefill=True),
               dict(enable_prefix_caching=True)):
        with pytest.raises(AssertionError, match="MLA"):
            JEngine(jcfg, params, **kw)
        with pytest.raises(AssertionError, match="MLA"):
            TEngine(tcfg, model, device="cpu", **kw)
    # the packed request falls back to the padded step, as the reference's
    teng = TEngine(tcfg, model, device="cpu", packed_attention=True)
    assert not teng._packed and not teng._fused and not teng._spec
    with pytest.raises(ValueError, match="MLA"):
        TM.apply_unified(model, {}, {})
    with pytest.raises(ValueError, match="MLA"):
        TM.apply_prefill_cached(model, {}, {})
    ids = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="training"):
        TM.apply_train(model, {"inputs": ids, "labels": ids})


def test_serve_launcher_runs_mla_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--num-requests", "4",
         "--max-new-tokens", "3", "--max-seqs", "2"],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "served 4 requests" in out.stdout
    assert "dispatch: {}" in out.stdout
    assert "'decode':" in out.stdout and "unified" not in out.stdout
