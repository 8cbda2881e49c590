"""The port's dense model against the JAX reference on the reduced
smollm-135m (fp32): the weight bridge, the primitive layers, and one
unified packed step (decode rows incl. a dead slot, a fresh chunk, a
resumed chunk, an empty chunk slot) through `M.apply_unified` with the
`pallas` (interpret mode) and `xla` backends.

Tolerance: last-token logits atol = 1e-4 (fp32; 4 layers of matmuls and
softmax summed in different orders), the written KV pages atol = 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.core.attention.heuristics import KernelConfig as JKernelConfig
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import weights
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.core.attention.heuristics import KernelConfig
from repro_torch.models import layers as TL
from repro_torch.models import model as TM


@pytest.fixture(scope="module")
def setup():
    jcfg = jreduced(JARCHS["smollm-135m"]).replace(dtype="float32")
    tcfg = treduced(TARCHS["smollm-135m"]).replace(dtype="float32")
    params = JM.init(jcfg, jax.random.key(0))
    params_np = jax.tree.map(np.asarray, params)
    model = weights.from_jax_params(tcfg, params_np, device="cpu")
    return jcfg, tcfg, params, params_np, model


def test_configs_match_reference():
    for name in ("smollm-135m", "llama3-405b", "qwen2.5-3b"):
        assert dataclasses.astuple(TARCHS[name]) == \
            dataclasses.astuple(JARCHS[name])
        assert dataclasses.astuple(treduced(TARCHS[name])) == \
            dataclasses.astuple(jreduced(JARCHS[name]))
    assert TARCHS["smollm-135m"].param_dtype == torch.bfloat16


def test_from_jax_params_round_trip(setup):
    _, tcfg, _, params_np, model = setup
    np.testing.assert_array_equal(model.embed.numpy(),
                                  params_np["embed"]["table"])
    np.testing.assert_array_equal(model.ln_f.scale.numpy(),
                                  params_np["ln_f"]["scale"])
    blocks = params_np["blocks"]
    for i, blk in enumerate(model.blocks):
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(
                getattr(blk.attn, name).w.numpy(),
                blocks["attn"][name]["w"][i])
        for name in ("gate", "up", "down"):
            np.testing.assert_array_equal(
                getattr(blk.mlp, name).w.numpy(),
                blocks["mlp"][name]["w"][i])
        np.testing.assert_array_equal(blk.ln1.scale.numpy(),
                                      blocks["ln1"]["scale"][i])
    assert len(model.blocks) == tcfg.num_layers


def test_from_jax_params_bfloat16_exact():
    jcfg = jreduced(JARCHS["smollm-135m"]).replace(dtype="bfloat16",
                                                   num_layers=1)
    tcfg = treduced(TARCHS["smollm-135m"]).replace(dtype="bfloat16",
                                                   num_layers=1)
    params_np = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.key(3)))
    model = weights.from_jax_params(tcfg, params_np, device="cpu")
    assert model.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        model.blocks[0].attn.wq.w.float().numpy(),
        params_np["blocks"]["attn"]["wq"]["w"][0].astype(np.float32))


def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32) * 3
    scale = rng.standard_normal((64,)).astype(np.float32)
    np.testing.assert_allclose(
        TL.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(JL.rms_norm({"scale": jnp.asarray(scale)},
                               jnp.asarray(x))), atol=1e-6, rtol=1e-6)
    # rope at large positions (fp32 angles up to ~1e5 rad)
    pos = np.asarray([[0, 1, 17, 2047, 99991]] * 2, np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)
    # SwiGLU mlp
    d, f = 16, 24
    w = {k: rng.standard_normal(s).astype(np.float32) * 0.3 for k, s in
         (("gate", (d, f)), ("up", (d, f)), ("down", (f, d)))}
    h = rng.standard_normal((3, d)).astype(np.float32)
    mlp = TL.MLP(d, f, dtype=torch.float32)
    for k, v in w.items():
        getattr(mlp, k).w.data.copy_(torch.from_numpy(v))
    want = JL.mlp({k: {"w": jnp.asarray(v)} for k, v in w.items()},
                  jnp.asarray(h))
    np.testing.assert_allclose(mlp(torch.from_numpy(h)).detach().numpy(),
                               np.asarray(want), atol=1e-5, rtol=1e-5)


def _packed_batch(cfg, num_pages, np_, ms=3, seed=0):
    """Mixed packed step: decode rows at contexts (20, dead, 35); chunks: a
    fresh chunk of 12, a resumed chunk of 9 at context 30, an empty slot.
    The prior context lives in the (random) cache already."""
    rng = np.random.default_rng(seed)
    ps = cfg.page_size
    s = 2 * ms
    dec_ctx = [20, 0, 35]
    chunks = [(0, 12), (30, 9)]  # (chunk_start, n)
    n_pref = sum(n for _, n in chunks)
    t = ms + max(1 << (n_pref - 1).bit_length(), ps)
    trash = num_pages * ps
    pt = np.zeros((s, np_), np.int32)
    for i in range(s):
        pt[i] = 1 + i * np_ + np.arange(np_)
    tokens = rng.integers(1, cfg.vocab_size, size=(1, t)).astype(np.int32)
    pos = np.zeros((1, t), np.int32)
    slots = np.full((1, t), trash, np.int32)
    qlens = np.zeros((s,), np.int32)
    ctx = np.zeros((s,), np.int32)
    qsl = np.full((s + 1,), ms, np.int32)
    qsl[:ms + 1] = np.arange(ms + 1)
    qlens[:ms] = 1
    for i, c in enumerate(dec_ctx):
        if c:
            pos[0, i] = c - 1
            ctx[i] = c
            slots[0, i] = pt[i, (c - 1) // ps] * ps + (c - 1) % ps
        else:
            tokens[0, i] = 0
    cur = ms
    for j, (start, n) in enumerate(chunks):
        i = ms + j
        p = np.arange(start, start + n)
        pos[0, cur:cur + n] = p
        slots[0, cur:cur + n] = pt[i, p // ps] * ps + p % ps
        ctx[i] = start + n
        qlens[i] = n
        cur += n
        qsl[i + 1:] = cur
    return {"inputs": tokens, "positions": pos, "page_table": pt,
            "context_lens": ctx, "query_lens": qlens,
            "query_start_loc": qsl, "slot_mapping": slots}


@pytest.mark.parametrize("backend,variant", [("xla", "gqa"),
                                             ("pallas", "gqa"),
                                             ("pallas", "segmented")])
def test_apply_unified_matches_reference(setup, backend, variant):
    jcfg, tcfg, params, _, model = setup
    ms, num_pages, np_ = 3, 40, 6
    batch = _packed_batch(tcfg, num_pages, np_, ms=ms)
    rng = np.random.default_rng(1)
    shape = (tcfg.num_layers, tcfg.num_kv_heads, 1, num_pages,
             tcfg.page_size, tcfg.resolved_head_dim)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    jcache = {"attn": {"k_pages": jnp.asarray(kp), "v_pages": jnp.asarray(vp)}}
    want, jnew = JM.apply_unified(
        jcfg, params, jcache, {k: jnp.asarray(v) for k, v in batch.items()},
        backend=backend, kernel_cfg=JKernelConfig(variant, num_segments=2),
        num_decode_seqs=ms)
    tcache = {"k_pages": torch.from_numpy(kp.copy()),
              "v_pages": torch.from_numpy(vp.copy())}
    got, tnew = TM.apply_unified(
        model, tcache, {k: torch.from_numpy(v) for k, v in batch.items()},
        kernel_cfg=KernelConfig(variant, num_segments=2), num_decode_seqs=ms)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    for name in ("k_pages", "v_pages"):
        np.testing.assert_allclose(tnew[name].numpy(),
                                   np.asarray(jnew["attn"][name]), atol=1e-5)


def test_apply_unified_token_source_routing(setup):
    """Rows with token_source >= 0 read their input id from prev_tokens
    (the async loop's device-side routing), as in the reference."""
    jcfg, tcfg, params, _, model = setup
    ms, num_pages, np_ = 3, 40, 6
    batch = _packed_batch(tcfg, num_pages, np_, ms=ms, seed=4)
    t = batch["inputs"].shape[1]
    src = np.full((1, t), -1, np.int32)
    src[0, 0], src[0, 2] = 4, 1
    batch["token_source"] = src
    batch["prev_tokens"] = np.arange(7, 7 + 2 * ms, dtype=np.int32)
    shape = (tcfg.num_layers, tcfg.num_kv_heads, 1, num_pages,
             tcfg.page_size, tcfg.resolved_head_dim)
    kp = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    want, _ = JM.apply_unified(
        jcfg, params, {"attn": {"k_pages": jnp.asarray(kp),
                                "v_pages": jnp.asarray(kp)}},
        {k: jnp.asarray(v) for k, v in batch.items()}, backend="xla",
        num_decode_seqs=ms)
    got, _ = TM.apply_unified(
        model, {"k_pages": torch.from_numpy(kp.copy()),
                "v_pages": torch.from_numpy(kp.copy())},
        {k: torch.from_numpy(v) for k, v in batch.items()},
        num_decode_seqs=ms)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
