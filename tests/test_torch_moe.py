"""The port's MoE family against the JAX reference on reduced
llama4-maverick-400b-a17b (fp32: 4 layers, d 256, 10 q / 2 KV heads of
D 64, 4 experts of ff 128, top-1, one shared expert), inputs from numpy
seeds:

  * `MoE` against `moe_ffn_dropless` at top_k 1 and 2, with every row on
    one expert, with empty experts and with exact ties: the chosen
    expert ids equal first, then the output (atol 1e-5: a few fp32
    products summed in another order);
  * the plain grouped GEMM against `jax.lax.ragged_dot` (and its SwiGLU
    pair) on group sizes with empty groups (1e-5);
  * `apply_unified`, `apply_prefill` and `apply_decode` logits against
    the reference's (1e-4: 4 layers), also with a `first_k_dense=1`
    variant (a leading dense block in `lead_blocks`);
  * the weight bridge both ways;
  * the engine token for token against the JAX engine: packed with
    chunked prefill at 16, padded, and packed with prefix caching;
  * `launch.serve --arch llama4-maverick-400b-a17b --reduced`;
  * `init_random`: a MoE model drawn one expert matrix at a time on its
    device, and smollm's CPU draws bit for bit what they were.

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
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.serving.engine import Engine as JEngine
from repro.serving.request import Request as JRequest
from repro_torch import weights
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.kernels.moe import kernel as GK
from repro_torch.models import model as TM
from repro_torch.models.moe import MoE
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.request import Request as TRequest, State

ARCH = "llama4-maverick-400b-a17b"
ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)


def _build():
    jcfg = jreduced(JARCHS[ARCH]).replace(dtype="float32")
    tcfg = treduced(TARCHS[ARCH]).replace(dtype="float32")
    params = JM.init(jcfg, jax.random.key(0))
    params_np = jax.tree.map(np.asarray, params)
    model = weights.from_jax_params(tcfg, params_np, device="cpu")
    return jcfg, tcfg, params, params_np, model


@pytest.fixture(scope="module")
def mav():
    return _build()


@pytest.fixture(scope="module")
def mav_lead(mav):
    """`first_k_dense=1`: the reference's tree with one leading dense
    block in "lead_blocks", the MoE blocks after it (mav's layers 1-3; the
    dense block's MLP drawn with numpy)."""
    jcfg, tcfg, _, params_np, _ = mav
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
# the MoE layer and the grouped GEMM
# ---------------------------------------------------------------------------


def _layer(built, top_k, router=None):
    """(jcfg, layer-0 MoE params, the port's MoE holding them) at top_k,
    with the router weight replaced by `router` if given."""
    jcfg, tcfg, params, params_np, _ = built
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, top_k=top_k))
    tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, top_k=top_k))
    p_np = jax.tree.map(lambda a: np.array(a[0]), params_np["blocks"]["moe"])
    if router is not None:
        p_np["router"]["w"] = router
    moe = MoE(tcfg)
    for path, t in weights._moe_leaves(moe):
        src = p_np
        for key in path:
            src = src[key]
        t.copy_(torch.from_numpy(src))
    return jcfg, jax.tree.map(jnp.asarray, p_np), moe


def _routing_case(case, d, e, rng):
    """(x [2, 9, d], router [d, e] or None) of a routing case."""
    x = rng.standard_normal((2, 9, d)).astype(np.float32)
    if case in ("uniform", "ties"):
        if case == "ties":  # zero rows: every router logit 0
            x[0, :4] = 0.0
        return x, None
    w = rng.standard_normal((d, e)).astype(np.float32) * d ** -0.5
    x = np.abs(x) + 0.1
    if case == "one_expert":  # every row's logit 2 is the only positive one
        w = -np.abs(w)
        w[:, 2] = 1.0 / d
    else:  # "empty": experts 0 and 3 never win
        w[:, 0] = w[:, 3] = -1.0
    return x, w


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("case", ["uniform", "one_expert", "empty", "ties"])
def test_moe_matches_dropless_reference(mav, top_k, case):
    tcfg = mav[1]
    rng = np.random.default_rng(11)
    x, router = _routing_case(case, tcfg.d_model, tcfg.moe.num_experts, rng)
    jcfg, jp, moe = _layer(mav, top_k, router)
    # the expert ids first: the reference's routing, line for line
    probs = jax.nn.softmax(
        jnp.asarray(x.reshape(-1, x.shape[-1])) @ jp["router"]["w"], axis=-1)
    jw, ji = jax.lax.top_k(probs, top_k)
    tw, ti = moe.route(torch.from_numpy(x.reshape(-1, x.shape[-1])))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    jw = jw / jnp.clip(jnp.sum(jw, -1, keepdims=True), 1e-9)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    chosen = set(np.asarray(ji).ravel().tolist())
    if case == "one_expert":  # every row's best expert is 2
        assert np.all(np.asarray(ji)[:, 0] == 2)
    if case == "empty":
        assert not chosen & {0, 3}
    if case == "ties":  # the lower ids win an exact tie, as in jax
        np.testing.assert_array_equal(ti.numpy()[:4],
                                      np.tile(np.arange(top_k), (4, 1)))
    want, _ = JMOE.moe_ffn_dropless(jcfg, jp, jnp.asarray(x))
    got, aux = moe(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert float(aux) == 0.0


def test_moe_refuses_training(mav):
    moe = mav[4].blocks[0].moe
    with pytest.raises(NotImplementedError, match="moe_ffn"):
        moe(torch.zeros((1, 2, mav[1].d_model)), mode="train")
    ids = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="training"):
        TM.apply_train(mav[4], {"inputs": ids, "labels": ids})


@pytest.mark.parametrize("sizes", [(3, 3, 3, 3), (0, 12, 0, 0),
                                   (5, 0, 0, 7), (0, 70, 2, 0)])
@pytest.mark.parametrize("glu", [False, True])
def test_plain_grouped_gemm_matches_ragged_dot(sizes, glu):
    rng = np.random.default_rng(sum(sizes))
    e, k, n = len(sizes), 24, 40
    r = sum(sizes)
    xs = rng.standard_normal((r, k)).astype(np.float32)
    w0 = rng.standard_normal((e, k, n)).astype(np.float32)
    w1 = rng.standard_normal((e, k, n)).astype(np.float32)
    gs = jnp.asarray(sizes, jnp.int32)
    want = jax.lax.ragged_dot(jnp.asarray(xs), jnp.asarray(w0), gs)
    if glu:
        want = jax.nn.silu(want) * jax.lax.ragged_dot(
            jnp.asarray(xs), jnp.asarray(w1), gs)
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]),
                           dtype=torch.int32)
    got = GK.grouped_gemm(torch.from_numpy(xs), torch.from_numpy(w0),
                          offsets, torch.from_numpy(w1) if glu else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert GK.LAUNCHES[GK.NAME] == 0  # the CPU never launches the kernel


def test_grouped_gemm_rejects_bad_offsets():
    xs = torch.zeros((5, 8))
    w = torch.zeros((2, 8, 8))
    with pytest.raises(ValueError, match="offsets"):
        GK.grouped_gemm(xs, w, torch.tensor([0, 2, 4], dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        GK.grouped_gemm(xs, w, torch.tensor([0, 2, 5]))


# ---------------------------------------------------------------------------
# the model's serving steps and the weight bridge
# ---------------------------------------------------------------------------


def _packed_batch(cfg, num_pages, np_, ms=3, seed=0):
    """Decode rows at contexts (20, dead, 35), a fresh chunk of 12 and a
    resumed chunk of 9 at context 30, padded to a token bucket."""
    rng = np.random.default_rng(seed)
    ps, s = cfg.page_size, 2 * ms
    chunks = [(0, 12), (30, 9)]
    t = ms + 32
    pt = (1 + np.arange(s)[:, None] * np_ + np.arange(np_)).astype(np.int32)
    tokens = rng.integers(1, cfg.vocab_size, size=(1, t)).astype(np.int32)
    pos = np.zeros((1, t), np.int32)
    slots = np.full((1, t), num_pages * ps, np.int32)
    qlens, ctx = np.zeros((s,), np.int32), np.zeros((s,), np.int32)
    qsl = np.full((s + 1,), ms, np.int32)
    qsl[:ms + 1] = np.arange(ms + 1)
    qlens[:ms] = 1
    for i, c in enumerate([20, 0, 35]):
        if c:
            pos[0, i], ctx[i] = c - 1, c
            slots[0, i] = pt[i, (c - 1) // ps] * ps + (c - 1) % ps
        else:
            tokens[0, i] = 0
    cur = ms
    for j, (start, n) in enumerate(chunks):
        i, p = ms + j, np.arange(start, start + n)
        pos[0, cur:cur + n] = p
        slots[0, cur:cur + n] = pt[i, p // ps] * ps + p % ps
        ctx[i], qlens[i] = start + n, n
        cur += n
        qsl[i + 1:] = cur
    return {"inputs": tokens, "positions": pos, "page_table": pt,
            "context_lens": ctx, "query_lens": qlens,
            "query_start_loc": qsl, "slot_mapping": slots}


@pytest.mark.parametrize("variant", ["plain", "first_k_dense"])
def test_apply_unified_matches_reference(mav, mav_lead, variant):
    jcfg, tcfg, params, _, model = mav if variant == "plain" else mav_lead
    assert len(model.lead_blocks) == (variant == "first_k_dense")
    ms, num_pages, np_ = 3, 40, 6
    batch = _packed_batch(tcfg, num_pages, np_, ms=ms)
    shape = (tcfg.num_layers, tcfg.num_kv_heads, 1, num_pages,
             tcfg.page_size, tcfg.resolved_head_dim)
    rng = np.random.default_rng(1)
    kp, vp = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    jb, tb = _both(batch)
    want, jnew = JM.apply_unified(
        jcfg, params, {"attn": {"k_pages": jnp.asarray(kp),
                                "v_pages": jnp.asarray(vp)}}, jb,
        backend="xla", num_decode_seqs=ms)
    got, tnew = TM.apply_unified(
        model, {"k_pages": torch.from_numpy(kp.copy()),
                "v_pages": torch.from_numpy(vp.copy())}, tb,
        num_decode_seqs=ms)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("k_pages", "v_pages"):
        np.testing.assert_allclose(tnew[name].numpy(),
                                   np.asarray(jnew["attn"][name]), atol=1e-5)


def test_prefill_then_decode_match_reference(mav):
    jcfg, tcfg, params, _, model = mav
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
    jb, tb = _both({"inputs": tokens[:, :s], "positions": pos,
                    "page_table": pt, "context_lens": qlens,
                    "query_lens": qlens})
    jl, jcache = JM.apply_prefill(jcfg, params, jcache, jb)
    tl, tcache = TM.apply_prefill(model, tcache, tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jb, tb = _both({"inputs": tokens[np.arange(b), qlens][:, None],
                    "positions": qlens[:, None], "page_table": pt,
                    "context_lens": qlens + 1})
    jl, jcache = JM.apply_decode(jcfg, params, jcache, jb)
    tl, tcache = TM.apply_decode(model, tcache, tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tcache["attn"]["k_pages"].numpy(),
                               np.asarray(jcache["attn"]["k_pages"]),
                               atol=1e-5)


def test_weight_bridge_round_trips(mav_lead):
    _, tcfg, _, params_np, model = mav_lead
    back = weights.to_numpy_params(model)
    assert jax.tree.structure(back) == jax.tree.structure(params_np)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(params_np)):
        np.testing.assert_array_equal(got, want)
    again = weights.from_jax_params(tcfg, back, device="cpu")
    for (_, _, a), (_, _, b) in zip(weights._leaves(model),
                                    weights._leaves(again)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _prompts(vocab, lens, seed=0, prefix=0):
    rng = np.random.default_rng(seed)
    shared = list(map(int, rng.integers(1, vocab, size=prefix)))
    return [shared + list(map(int, rng.integers(1, vocab, size=n)))
            for n in lens]


@pytest.mark.parametrize("mode", ["packed_chunked", "padded",
                                  "prefix_cached"])
def test_engine_matches_reference(mav, mode):
    """The 3-prompt trace (5, 17, 33 tokens, 6 new each, greedy); the
    prefix-cached run gives the three a 32-token shared prefix."""
    jcfg, tcfg, params, _, model = mav
    kw = dict(max_seqs=4, num_pages=64, max_model_len=256)
    kw |= {"packed_chunked": dict(enable_chunked_prefill=True,
                                  max_prefill_tokens=16),
           "padded": dict(packed_attention=False),
           "prefix_cached": dict(enable_prefix_caching=True)}[mode]
    prompts = _prompts(tcfg.vocab_size, (5, 17, 33),
                       prefix=32 if mode == "prefix_cached" else 0)
    jeng = JEngine(jcfg, params, **kw)
    teng = TEngine(tcfg, model, device="cpu", **kw)
    jreqs = [JRequest(prompt=list(p), max_new_tokens=6) for p in prompts]
    treqs = [TRequest(prompt=list(p), max_new_tokens=6) for p in prompts]
    if mode == "prefix_cached":  # the first request fills the cache
        jeng.generate(jreqs[:1])
        teng.generate(treqs[:1])
        jreqs, treqs = jreqs[1:], treqs[1:]
    jeng.generate(jreqs)
    teng.generate(treqs)
    assert all(r.state is State.FINISHED for r in treqs)
    for i, (a, b) in enumerate(zip(jreqs, treqs)):
        assert a.output == b.output, (i, a.output, b.output)
    assert teng.step_idx == jeng.step_idx
    assert teng.launched_token_slots == jeng.launched_token_slots
    assert dict(teng.dispatch_counts) == dict(jeng.dispatch_counts)
    assert teng._packed == (mode != "padded")
    if mode == "prefix_cached":
        assert teng.cached_prefill_tokens == jeng.cached_prefill_tokens > 0


def test_serve_launcher_runs_moe_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--num-requests", "4",
         "--max-new-tokens", "3", "--max-seqs", "2", "--chunked-prefill",
         "--max-prefill-tokens", "32"],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "served 4 requests" in out.stdout
    assert "device calls: {'unified':" in out.stdout


# ---------------------------------------------------------------------------
# random init
# ---------------------------------------------------------------------------


def test_init_random_moe_draws_one_expert_matrix_at_a_time(monkeypatch):
    tcfg = treduced(TARCHS[ARCH]).replace(dtype="bfloat16")
    draws = []
    real = torch.nn.init.trunc_normal_

    def spy(t, *a, **kw):
        draws.append((tuple(t.shape), t.device.type,
                      kw["generator"].device.type))
        return real(t, *a, **kw)

    monkeypatch.setattr(torch.nn.init, "trunc_normal_", spy)
    model = weights.init_random(tcfg, 3, device="cpu")
    d, ff = tcfg.d_model, tcfg.moe.d_ff_expert
    e = tcfg.moe.num_experts
    drawn = [p for p, _, _ in weights._leaves(model)
             if p[-1] not in ("scale", "b")]
    # each leaf once, but gate, up and down: once per expert matrix
    assert len(draws) == len(drawn) + 3 * (e - 1) * tcfg.num_layers
    assert draws.count(((ff, d), "cpu", "cpu")) == e * tcfg.num_layers + \
        tcfg.num_layers  # w_down's matrices and the shared down
    assert all(len(s) <= 2 for s, _, _ in draws)
    assert all(dev == g == "cpu" for _, dev, g in draws)
    blk = model.blocks[0].moe
    assert blk.w_gate.dtype == torch.bfloat16
    std = d ** -0.5
    w = blk.w_gate.float()
    assert float(w.abs().max()) <= 2 * std * 1.01
    assert 0.7 * std < float(w.std()) < 0.95 * std  # +-2 std truncated
    assert not torch.equal(blk.w_gate[0], blk.w_gate[1])
    again = weights.init_random(tcfg, 3, device="cpu")
    for (_, _, a), (_, _, b) in zip(weights._leaves(model),
                                    weights._leaves(again)):
        assert torch.equal(a, b)


def test_init_random_cpu_draws_unchanged_for_dense():
    """smollm's CPU draws: the whole model on the CPU, every leaf drawn
    whole in `_leaves` order by one CPU generator (the function as it was
    before MoE models drew on their device)."""
    tcfg = treduced(TARCHS["smollm-135m"]).replace(dtype="bfloat16")
    got = weights.init_random(tcfg, 5, device="cpu")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(5)
    want = TM.Model(tcfg, device="cpu")
    with torch.no_grad():
        for path, _, t in weights._leaves(want):
            name = path[-1]
            if name in ("scale", "d_skip"):
                t.fill_(1.0)
            elif name in ("b", "a_log", "dt_bias"):
                t.zero_()
            else:
                fan_in = {"table": tcfg.d_model, "r": t.shape[-1]}.get(
                    name, t.shape[0])
                std = fan_in ** -0.5
                tmp = torch.empty(t.shape, dtype=torch.float32)
                torch.nn.init.trunc_normal_(tmp, 0.0, std, -2 * std,
                                            2 * std, generator=gen)
                t.copy_(tmp.to(t.dtype))
    for (pa, _, a), (_, _, b) in zip(weights._leaves(got),
                                     weights._leaves(want)):
        assert torch.equal(a, b), pa
